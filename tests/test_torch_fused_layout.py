"""The fused interior's options and the kernel's argument layout on the
CPU: the options the fused step refuses (as JAX's does), and
``csrc/interior_step.cu``'s enums, tiles and parameter pack against the
Python side (``ops/cuda_step.py``, ``ops/kernel_params.py``).  The
kernels themselves run only on the card (tests/test_torch_cuda.py)."""

import ast
import dataclasses
import inspect
import re
import textwrap

import pytest

from ocean_bgc_tpu_torch.models.coupled import step
from ocean_bgc_tpu_torch.ops import bgc, cuda_step, particulates
from ocean_bgc_tpu_torch.ops.cuda_step import KERNEL_FIELDS
from ocean_bgc_tpu_torch.ops.kernel_params import (
    GLOBAL_FIELDS,
    NUM_PARAMS,
    TRAIT_FIELDS,
    check_traits,
    pack_bgc_params,
)
from ocean_bgc_tpu_torch.params import BGCParams, ModelParams
from ocean_bgc_tpu_torch.utils.bridge import world_from_numpy
from tests.test_torch_fused import CSRC, DT, _np_world


@pytest.mark.parametrize("kwargs", [dict(compute_diags=True),
                                    dict(compute_diags=False, health=True),
                                    dict(compute_diags=False,
                                         interior_impl="pallas")])
def test_fused_refuses_what_jax_refuses(kwargs):
    s, g, f = world_from_numpy(*_np_world(nlev=2, ncol=4), device="cpu")
    kw = dict(interior_impl="fused")
    kw.update(kwargs)
    with pytest.raises(ValueError):
        step(s, g, f, ModelParams(), DT, **kw)


def _enum(name):
    """The enumerator names of ``enum <name>`` in interior_step.cu, the
    trailing count excluded."""
    src = (CSRC / "interior_step.cu").read_text()
    body = re.search(r"enum " + name + r" : int \{(.*?)\};", src, re.S)[1]
    body = re.sub(r"//[^\n]*", "", body)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1].endswith("_COUNT")
    return names[:-1]


def _attributes_read(fn, owners):
    """Attribute names read as ``<owner>.<name>`` in a function's source."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    return {node.attr for node in ast.walk(tree)
            if isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id in owners}


def test_kernel_argument_layout_matches_python():
    """A silent mismatch between the kernel's enums and the Python lists
    would give plausible but wrong physics: the enums must list exactly
    the packed parameters and pointer fields, in order, and the pack must
    hold every parameter the plain interior reads."""
    assert _enum("GlobalParam") == ["P_" + f for f in GLOBAL_FIELDS]
    assert _enum("TraitParam") == ["A_" + f for f in TRAIT_FIELDS]
    assert _enum("Field") == ["F_" + f for f in KERNEL_FIELDS]

    interior = (bgc.ecosystem_kinetics, bgc.assemble_tendencies,
                bgc.compute_restoring, bgc.bgc_source_sink,
                particulates.particulate_level_update)
    read = set().union(*(_attributes_read(fn, {"params"})
                         for fn in interior))
    # consumed by precompute_dissolution before the kernel runs (the
    # plain version reads them only when no dissolution factors are given)
    wrapper_side = {"parm_SiO2_diss", "parm_CaCO3_diss"}
    bgc_fields = {f.name for f in dataclasses.fields(BGCParams)}
    assert read - wrapper_side - {"autotrophs"} == set(GLOBAL_FIELDS)
    assert set(GLOBAL_FIELDS) <= bgc_fields
    traits = set().union(*(_attributes_read(fn, {"au", "au2"})
                           for fn in interior))
    assert traits == set(TRAIT_FIELDS)


def test_biology_kernel_tiles_match_python():
    """The wrapper plans the biology kernel's tiles for the block size and
    the staged fields the kernel declares: whole columns, at least one,
    two blocks' staging within an SM's shared memory."""
    src = (CSRC / "interior_step.cu").read_text()
    assert int(re.search(r"constexpr int kBioThreads = (\d+);", src)[1]) \
        == cuda_step.BIO_THREADS
    assert len(_enum("Stage")) == cuda_step.STAGED_FIELDS
    assert cuda_step.columns_per_block(60, 8) == 16
    assert cuda_step.columns_per_block(60, 4) == 32
    assert cuda_step.columns_per_block(5000, 8) == 1
    assert 2 * cuda_step.TILE_BYTES <= 227 * 1024


def test_pack_holds_each_field_at_its_enum_slot():
    params = dataclasses.replace(BGCParams(), parm_POC_diss=1234.5,
                                 lrest_sio3=True)
    packed = pack_bgc_params(params)
    assert len(packed) == NUM_PARAMS
    assert all(type(v) is float for v in packed)
    for i, name in enumerate(GLOBAL_FIELDS):
        assert packed[i] == float(getattr(params, name)), name
    for g, au in enumerate(params.autotrophs):
        for j, name in enumerate(TRAIT_FIELDS):
            slot = len(GLOBAL_FIELDS) + g * len(TRAIT_FIELDS) + j
            assert packed[slot] == float(getattr(au, name)), name


def test_traits_that_do_not_fit_the_layout_raise():
    p = BGCParams()
    bad = dataclasses.replace(p.autotrophs[0], has_si=True)
    with pytest.raises(ValueError, match="has_si"):
        check_traits(dataclasses.replace(p, autotrophs=(bad,)
                                         + p.autotrophs[1:]))
    with pytest.raises(ValueError, match="autotroph groups"):
        check_traits(dataclasses.replace(p, autotrophs=p.autotrophs[:3]))
