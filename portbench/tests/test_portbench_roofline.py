"""The yardstick's arithmetic against hand sums, and the readers on a
trace made by hand."""

from types import SimpleNamespace

import pytest

from portbench import roofline
from portbench.run import reader
from portbench.trace import Kernel, Trace, base_name, breakdown


def test_step_bytes_is_the_hand_sum():
    # per column at 2 levels: the state (37 a level, 2 a column) in and
    # out, 3 forcing fields a level and 10 a column, 3 grid fields a
    # level and 1 a column, at 8 bytes; kmax at 4 bytes
    per_col = 2 * (37 * 2 + 2) + 3 * 2 + 10 + 3 * 2 + 1
    assert per_col == 175
    assert roofline.step_bytes(2, 3, "float64") == 3 * (175 * 8 + 4)
    assert roofline.step_bytes(2, 3, "float32") == 3 * (175 * 4 + 4)


def test_k1_bytes_are_the_hand_sums():
    assert roofline.k1_dual_bytes(6, "float64") == (21 + 8) * 6 * 8
    assert roofline.k1_bracket_bytes(6, 3, "float64") == (4 * 6 + 18 * 3) * 8
    assert roofline.k1_bracket_bytes(6, 3, "float32") == (4 * 6 + 18 * 3) * 4


def test_base_names_of_kernels():
    assert base_name("void obgc::(anonymous namespace)::lanes_kernel<double, "
                     "obgc::(anonymous namespace)::DualLanes<double, false> >"
                     "(obgc::(anonymous namespace)::DualLanes<double, false>,"
                     " long)") == "lanes_kernel"
    assert base_name("void at::native::vectorized_elementwise_kernel<2, "
                     "at::native::FillFunctor<double> >(int)") == (
                         "vectorized_elementwise_kernel")
    assert base_name("void obgc::(anonymous namespace)::coeffs_kernel<double>"
                     "(obgc::(anonymous namespace)::CoeffArgs<double>, long,"
                     " long, bool)") == "coeffs_kernel"


DUAL = "void obgc::lanes_kernel<double, obgc::DualLanes<double, false> >(x)"
BRACKET = ("void obgc::lanes_kernel<double, obgc::BracketLanes<double, "
           "false> >(x)")
EAGER = "void at::native::vectorized_elementwise_kernel<2, add>(int)"


def _ctx(kernels, copies=(), window=(0, 1000), steps=2, host_ns=1_500_000,
         host_steps=2, step_wall_s=800e-9, wall_s=None):
    tr = Trace(*window, kernels=list(kernels), copies=list(copies),
               host_ops=[("aten::mul", 0, 600), ("aten::add", 100, 200)],
               wall_s=wall_s)
    return SimpleNamespace(trace=tr, steps=steps, levels=4, columns=10,
                           dtype="float64", host_ns=host_ns,
                           host_steps=host_steps, step_wall_s=step_wall_s,
                           csrc_names={"lanes_kernel", "coeffs_kernel"})


def test_readers_on_a_trace_made_by_hand():
    ks = [Kernel(EAGER, 0, 100, 128), Kernel(DUAL, 150, 350, 64),
          Kernel(BRACKET, 400, 420, 32), Kernel(BRACKET, 500, 600, 40),
          Kernel(EAGER, 550, 650, 128)]
    ctx = _ctx(ks, copies=[("Memcpy HtoD", 900, 950)])
    assert reader("eager_kernel_ms_per_step")(ctx) == pytest.approx(
        200 / 1e6 / 2)
    assert reader("csrc_kernel_ms_per_step")(ctx) == pytest.approx(
        320 / 1e6 / 2)
    assert reader("host_ms_per_step")(ctx) == pytest.approx(0.75)
    # busy: [0,100] [150,350] [400,420] [500,650] [900,950] = 520 of 1000
    assert ctx.trace.busy_s() == pytest.approx(520e-9)
    # 260 ns busy a step against 800 ns of wall a step
    assert reader("device_idle_pct")(ctx) == pytest.approx(67.5)
    # K1: the dual on 40 cells, the bracket-in at 32 threads the surface
    # pair (20 lanes, 10 shared), at 40 threads the stand-in (40 and 40)
    nbytes = (roofline.k1_dual_bytes(40, "float64")
              + roofline.k1_bracket_bytes(20, 10, "float64")
              + roofline.k1_bracket_bytes(40, 40, "float64"))
    want = 100 * nbytes / 3.35e12 / (320e-9)
    assert reader("k1_roofline")(ctx) == pytest.approx(want)
    step = roofline.step_bytes(4, 10, "float64") / 3.35e12
    assert reader("step_roofline")(ctx) == pytest.approx(
        100 * step / 800e-9)
    # the window's length by the host's clock, where the trace has it
    tr = _ctx(ks, copies=[("Memcpy HtoD", 900, 950)], wall_s=2000e-9).trace
    assert tr.window_s == pytest.approx(2000e-9)


def test_a_reader_with_nothing_to_read_returns_nothing():
    ctx = _ctx([Kernel(EAGER, 0, 100, 128)])
    assert reader("k1_roofline")(ctx) is None
    assert reader("csrc_kernel_ms_per_step")(ctx) is None
    # a bracket-in launch too small for either lane count is left out
    ctx = _ctx([Kernel(BRACKET, 0, 100, 8)])
    assert reader("k1_roofline")(ctx) is None
    # a traced run with no untraced step has no host numbers
    ctx = _ctx([Kernel(EAGER, 0, 100, 128)], host_steps=0, step_wall_s=None)
    assert reader("host_ms_per_step")(ctx) is None
    assert reader("step_roofline")(ctx) is None
    assert reader("device_idle_pct")(ctx) is None


def test_breakdown_names_ops_and_gaps():
    ks = [Kernel(EAGER, 0, 100, 1), Kernel(DUAL, 300, 500, 1)]
    tr = _ctx(ks).trace
    br = breakdown(tr, tr)
    assert br["device_ops"][0] == [DUAL, 200e-9]
    # gaps [100,300] (midpoint 200: inside aten::add's [100,200)? no,
    # aten::mul's [0,600)) and [500,1000] (midpoint 750: none)
    assert dict(br["idle_gaps"]) == pytest.approx(
        {"aten::mul": 200e-9, "python outside operators": 500e-9})
