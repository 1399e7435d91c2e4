"""ocean_bgc_tpu_torch — the PyTorch/CUDA port of ``ocean_bgc_tpu``.

The same column physics (BGC + DMS + MACROS + co2calc + air-sea fluxes)
as plain functions on torch tensors, with the per-cell dual pH solve as a
hand-written CUDA kernel for Hopper (``csrc/carbonate_dual.cu``).  The
JAX package is the reference this port is held against; this package
imports none of it.

Entry points that create tensors (``utils.synthetic.synthetic_world``,
``utils.bridge.world_from_numpy``, ``io.model_io.load_world``,
``utils.checkpoint.restore``, ``state.zeros_state``), the host-coupling
API (``host_api``: NumPy in, NumPy out) and the model runner (``python -m
ocean_bgc_tpu_torch.run_model``) default to the CUDA device; pass
``device="cpu"`` (``--device cpu``) to run on the CPU, where each kernel's
plain PyTorch version stands in for it.  The port has no global precision
switch: every tensor carries its own type, float64 by default.
"""

from ocean_bgc_tpu_torch import constants, params, state  # noqa: F401
from ocean_bgc_tpu_torch.params import (  # noqa: F401
    BGCParams,
    DMSParams,
    MACROSParams,
    ModelParams,
)
from ocean_bgc_tpu_torch.state import (  # noqa: F401
    BGCForcing,
    BGCState,
    BGCTracers,
    ColumnGrid,
    DMSTracers,
    MACROSTracers,
)

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level conveniences (no import cycle at package init)."""
    if name in ("step", "run", "CoupledState"):
        from ocean_bgc_tpu_torch.models import coupled
        return getattr(coupled, name)
    if name in ("precompute_env", "EnvCache"):
        from ocean_bgc_tpu_torch.ops import bgc
        return getattr(bgc, name)
    if name == "synthetic_world":
        from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world
        return synthetic_world
    raise AttributeError(
        f"module 'ocean_bgc_tpu_torch' has no attribute {name!r}")
