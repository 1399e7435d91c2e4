"""The model's parameter set (its namelist) for the plain reference.

``namelist.json`` holds the E3SM Ocean-BGC defaults (BGC_parms.F90:
497-699, DMS_parms.F90:203-241, MACROS_parms.F90:143-162) as the
benchmark states them; the harness hands the same file to the program.
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

NAMELIST = Path(__file__).resolve().parent / "namelist.json"


def load_namelist(path=NAMELIST) -> dict:
    """The namelist as nested dicts: ``bgc`` (with ``autotrophs``, a list
    of four trait dicts), ``dms`` and ``macros``."""
    return json.loads(Path(path).read_text())


def reference_params(namelist: dict) -> SimpleNamespace:
    """The namelist as the reference reads it: ``p.bgc.parm_...``,
    ``p.bgc.autotrophs[g].kFe``, ``p.dms...``, ``p.macros...``."""
    bgc = dict(namelist["bgc"])
    bgc["autotrophs"] = [SimpleNamespace(**a) for a in bgc["autotrophs"]]
    return SimpleNamespace(bgc=SimpleNamespace(**bgc),
                           dms=SimpleNamespace(**namelist["dms"]),
                           macros=SimpleNamespace(**namelist["macros"]))
