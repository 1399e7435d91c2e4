"""The host API's tracer-order errors and the host-layout copy
(``io/host_layout.py``) against the JAX package's, on the CPU, bitwise."""

import numpy as np
import pytest

from ocean_bgc_tpu import host_api as japi
from ocean_bgc_tpu.io import host_layout as jhl

from ocean_bgc_tpu_torch import host_api as api
from ocean_bgc_tpu_torch.io import host_layout as hl
from ocean_bgc_tpu_torch.state import BGC_TRACER_NAMES


@pytest.mark.parametrize("case,match", [
    ("missing", "missing"), ("unknown", "unknown"),
    ("duplicate", "permutation")])
def test_tracer_permutation_errors(case, match):
    """The three ways a host index map fails, with JAX's texts."""
    good = {n: i for i, n in enumerate(BGC_TRACER_NAMES)}
    assert (api.tracer_permutation(good, BGC_TRACER_NAMES)
            == np.arange(30)).all()
    bad = dict(good)
    if case == "missing":
        bad.pop("PO4")
    elif case == "unknown":
        bad["not_a_tracer"] = 3
    else:
        bad["PO4"] = bad["NO3"]
    with pytest.raises(ValueError, match=match) as ours:
        api.tracer_permutation(bad, BGC_TRACER_NAMES)
    with pytest.raises(ValueError) as theirs:
        japi.tracer_permutation(bad, BGC_TRACER_NAMES)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_host_layout_copy_matches_jax(path, monkeypatch):
    """Every function of the host-layout copy bitwise JAX's, on the
    native packer and on the NumPy path."""
    assert hl.native_available() and jhl.native_available()
    if path == "numpy":
        monkeypatch.setattr(hl, "_load", lambda: None)
        assert not hl.native_available()
    rng = np.random.default_rng(7)
    lm = rng.standard_normal((37, 11))
    block = rng.standard_normal((23, 9, 30))
    for fn, x in (("to_level_major", lm), ("from_level_major", lm.T),
                  ("pack_tracer_block", block),
                  ("pack_tracer_block", block.astype(np.float32)),
                  ("unpack_tracer_block", block)):
        got, want = getattr(hl, fn)(x), getattr(jhl, fn)(x)
        assert got.dtype == want.dtype == np.float64, fn
        assert np.array_equal(got, want), fn
    assert np.array_equal(hl.to_level_major(lm), lm.T)
    assert np.array_equal(hl.unpack_tracer_block(hl.pack_tracer_block(
        block)), block)
    a = rng.standard_normal((40, 40))
    a[3, 7], a[10, 2], a[0, 0] = np.nan, np.inf, -np.inf
    b = a.copy()
    assert hl.scrub_nonfinite(a, fill=-1.0) == jhl.scrub_nonfinite(
        b, fill=-1.0) == 3
    assert np.array_equal(a, b) and a[3, 7] == -1.0
    with pytest.raises(ValueError, match="C-contiguous float64"):
        hl.scrub_nonfinite(a.T[::2])
