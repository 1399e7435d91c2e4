"""The port's copies and import boundary, held against the JAX package:
parameters, constants, tracer tables and the diagnostics registry must
be equal, and the port (plus chip_smoke.py) may import neither JAX nor
the JAX package.  The synthetic world and the device choice are in
``tests/test_torch_world.py``."""

import ast
import dataclasses
from pathlib import Path

import ocean_bgc_tpu  # noqa: F401  (enables x64)

from ocean_bgc_tpu import constants as jconst
from ocean_bgc_tpu import state as jstate
from ocean_bgc_tpu.params import ModelParams as JaxModelParams
from ocean_bgc_tpu.utils import diag as jdiag

from ocean_bgc_tpu_torch import constants as tconst
from ocean_bgc_tpu_torch import state as tstate
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.utils import diag as tdiag
from ocean_bgc_tpu_torch.utils.bridge import params_from_dict

REPO = Path(__file__).resolve().parent.parent


def test_params_carried_across_equal_defaults():
    got = params_from_dict(dataclasses.asdict(JaxModelParams()))
    assert got == ModelParams()
    # the copy itself matches field for field (no drift in defaults)
    assert dataclasses.asdict(ModelParams()) == dataclasses.asdict(
        JaxModelParams())


def test_constants_copy_has_not_drifted():
    names = {n for n in dir(jconst) if n.isupper()}
    assert names == {n for n in dir(tconst) if n.isupper()}
    for n in sorted(names):
        assert getattr(tconst, n) == getattr(jconst, n), n


def test_tracer_indices_and_names_have_not_drifted():
    for cls in ("BGCTracers", "DMSTracers", "MACROSTracers"):
        a, b = getattr(jstate, cls), getattr(tstate, cls)
        names = {n for n in vars(a) if n.isupper()}
        assert names == {n for n in vars(b) if n.isupper()}, cls
        for n in names:
            assert getattr(b, n) == getattr(a, n), (cls, n)
    for n in ("BGC_TRACER_NAMES", "BGC_TRACER_LONG_NAMES",
              "DMS_TRACER_NAMES", "DMS_TRACER_LONG_NAMES",
              "MACROS_TRACER_NAMES", "MACROS_TRACER_LONG_NAMES"):
        assert getattr(tstate, n) == getattr(jstate, n), n
    assert tstate.bgc_tracer_units() == jstate.bgc_tracer_units()


def test_diagnostics_registry_copy_has_not_drifted():
    """utils/diag.py is a copy: every table, entry and the coupled
    registry's names, kinds, units and descriptions equal the JAX
    package's."""
    for table in ("BGC_DIAGS", "BGC_FLUX_DIAGS", "DMS_DIAGS",
                  "DMS_FLUX_DIAGS", "MACROS_DIAGS"):
        a, b = getattr(jdiag, table), getattr(tdiag, table)
        assert list(b) == list(a), table
        assert all(tuple(b[k]) == tuple(a[k]) for k in a), table
    a, b = jdiag.coupled_registry(), tdiag.coupled_registry()
    assert list(b) == list(a) and len(b) == 155
    assert all(tuple(b[k]) == tuple(a[k]) for k in a)




def _forbidden_imports(path, module_level=False):
    """(line, module) of every import of jax or of the JAX package (with
    ``module_level``, of those the module runs when it is imported).
    ``ocean_bgc_tpu_torch`` shares the package's prefix and is allowed."""
    bad = []
    tree = ast.parse(path.read_text(), str(path))
    for node in tree.body if module_level else ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for m in mods:
            root = m.split(".")[0]
            if root in ("jax", "jaxlib", "ocean_bgc_tpu"):
                bad.append((node.lineno, m))
    return bad


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "ocean_bgc_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py"]
    # chip_smoke.py's check against the scalar oracle imports these
    files += sorted((REPO / "tests" / "oracle").glob("*.py"))
    assert len(files) > 15
    assert {"diag.py", "history.py", "cuda_carbonate.py", "sharding.py",
            "distributed.py", "entry.py"} <= {f.name for f in files}
    offenders = {str(f.relative_to(REPO)): _forbidden_imports(f)
                 for f in files}
    assert {k: v for k, v in offenders.items() if v} == {}


def test_gate_files_import_no_jax_when_imported():
    """``chip_smoke.py`` runs the long-horizon gates of these test files
    on the card, and the two-rank test runs its file as the ranks'
    script, where there is no JAX: importing them imports none of it
    (their tests that compare with JAX import it inside the test).  P's
    CPU tests need none either."""
    files = [REPO / "tests" / f"test_torch_{n}.py" for n in (
        "trajectory", "deep_world", "fp32_trajectory", "fp32_deep", "probe",
        "distributed")]
    offenders = {f.name: _forbidden_imports(f, module_level=True)
                 for f in files}
    assert {k: v for k, v in offenders.items() if v} == {}
    assert _forbidden_imports(files[-1]) != []    # its JAX test's imports


def test_import_guard_catches_each_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax\nfrom jax import numpy\n"
                   "import ocean_bgc_tpu.ops\nfrom ocean_bgc_tpu import x\n"
                   "import ocean_bgc_tpu_torch\n"
                   "from ocean_bgc_tpu_torch.ops import bgc\n"
                   "from . import sibling\n")
    assert [m for _, m in _forbidden_imports(src)] == [
        "jax", "jax", "ocean_bgc_tpu.ops", "ocean_bgc_tpu"]
