"""The default step's diagnostics against JAX's at f32: the tests of
``tests/test_torch_diags.py`` on their fixture's f32 run (two steps of
the same ragged world, JAX's reference with the env cache; see
``_runs``), in a file of their own so that each dtype's JAX compile runs
once, in one file."""

import pytest

from tests.test_torch_diags import (  # noqa: F401  (collected here)
    _runs,
    test_default_call_emits_the_jax_names,
    test_diagnostics_match_jax,
    test_filter_dtype_and_health_options,
    test_health_counters,
    test_health_step_evaluates_the_constants_once,
    test_run_sums_the_tracked_fields,
    test_saturation_depths_match_jax,
    test_tracers_do_not_depend_on_diagnostics,
)


@pytest.fixture(scope="module", params=["float32"])
def runs(request):
    """:func:`_runs` at f32."""
    return _runs(request.param)
