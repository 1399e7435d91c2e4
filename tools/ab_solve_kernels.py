"""Compare the unseeded solve kernels and P of two checkouts of this
repository on one NVIDIA GPU: their SASS, and their times in turns.

    python3 tools/ab_solve_kernels.py BEFORE_DIR AFTER_DIR

Each checkout runs in its own process (its own package and its own
kernel build), in the order BEFORE, AFTER, AFTER, BEFORE.  A process
builds the checkout's kernels, makes ``chip_smoke.py``'s flagship world
(60 x 8192, ragged) one step warm at f64 and f32, and times behind a
device sleep (``chip_smoke.cuda_ms(device_only=True)``) the launches of
K1's unseeded dual instance on the env cache's constants, its unseeded
bracket-in instance on the surface pair and K2's solve kernel, and P
(``probe.probe_patterns`` on the probe's inputs) beside the launch floor
(an empty kernel of one block of 32 threads).  Then
each kernel of ``carbonate_dual`` and ``interior_step`` is reported as
having the same SASS in both builds or not (``cuobjdump -sass``).  The
last line is a JSON object {checkout: {kernel: mean ms of its two
turns}}.  Both checkouts must have ``chip_smoke.py`` with
``k1_inputs``, ``surface_lanes`` and ``cuda_ms``, ``probe.py`` with
``probe_inputs`` and ``probe_patterns``, and ``obgc_empty_launch`` in
``csrc/carbonate_dual.cu``.
"""

import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

# the libraries whose kernels' SASS is compared
SASS_LIBRARIES = ("carbonate_dual", "interior_step")


def child(root):
    """Time one checkout's kernels; prints {"ms": {kernel: ms}, "libs":
    {library: its built path}} as JSON."""
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch

    from ocean_bgc_tpu_torch.models.coupled import step
    from ocean_bgc_tpu_torch.ops import _kernels
    from ocean_bgc_tpu_torch.ops import cuda_carbonate as cc
    from ocean_bgc_tpu_torch.ops import cuda_step as ck
    from ocean_bgc_tpu_torch.ops.bgc import precompute_env
    from ocean_bgc_tpu_torch.params import ModelParams
    from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world
    _kernels.build()
    params = ModelParams()
    res = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        state, grid, forcing = synthetic_world(
            nlev=cs.NLEV, ncol=cs.NCOL, seed=cs.SEED, ragged=True,
            dtype=dtype)
        env = precompute_env(grid, forcing, params.bgc)
        warm, _ = step(state, grid, forcing, params, cs.DT,
                       compute_diags=False, env=env)
        args = cs.k1_inputs(warm, grid, forcing, env)
        fields = (*args[:6], *args[6])
        largs = cs.surface_lanes(warm, forcing)
        bfields = dict(dic=largs[1], x1=largs[5], x2=largs[6], ta=largs[2],
                       pt=largs[3], sit=largs[4], **largs[0]._asdict())
        b = warm.bgc
        kfields = ck.kernel_inputs(b.tracers, grid, forcing, b.ph_prev_3d,
                                   b.ph_prev_alt_3d, params.bgc, env)
        got = ck.fused_interior_step(b.tracers, grid, forcing, b.ph_prev_3d,
                                     b.ph_prev_alt_3d, params.bgc, env=env,
                                     impl="kernel")
        out = ck.FusedInteriorOut(*(torch.empty_like(t) for t in got))
        for kernel, fn in (
                ("K1 dual", lambda: cc._launch(fields, dtype)),
                ("K1 bracket-in surface pair",
                 lambda: cc._launch_brackets(bfields)),
                ("K2 solve", lambda: ck._launch_solve(kfields, out))):
            res[f"{kernel} {name}"] = cs.cuda_ms(fn, reps=20,
                                                 device_only=True)
    from ocean_bgc_tpu_torch import probe
    lib = _kernels.load("carbonate_dual")
    lib.obgc_empty_launch.argtypes = [ctypes.c_uint, ctypes.c_int,
                                      ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    pargs = probe.probe_inputs()
    res["P float32"] = cs.cuda_ms(lambda: probe.probe_patterns(*pargs),
                                  reps=20, device_only=True)
    res["launch floor"] = cs.cuda_ms(
        lambda: lib.obgc_empty_launch(1, 32, stream), reps=20,
        device_only=True)
    libs = {n: str(_kernels.library_path(n)) for n in SASS_LIBRARIES}
    print(json.dumps({"ms": res, "libs": libs}))
    return 0


def sass(path):
    """{kernel: its SASS instructions} of the library at ``path``, the
    kernels named without the build's anonymous-namespace tag."""
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(cuda, "bin",
                                                     "cuobjdump")
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    res, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", m[1])
            res[name] = []
        elif name and line.strip().startswith("/*") and ";" in line:
            # the instruction, without its address and encoding
            res[name].append(line.split("*/", 1)[1].split(";")[0].strip())
    return res


def main(before, after):
    turns = []
    libs = {}
    for root in (before, after, after, before):
        root = os.path.abspath(root)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root],
            cwd=root, capture_output=True, text=True, check=True,
            timeout=600)
        got = json.loads(out.stdout.strip().splitlines()[-1])
        res, libs[root] = got["ms"], got["libs"]
        print(f"{root}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                      res.items()) + " ms", flush=True)
        turns.append((root, res))
    a, b = (os.path.abspath(r) for r in (before, after))
    for lib in SASS_LIBRARIES:
        sa, sb = sass(libs[a][lib]), sass(libs[b][lib])
        for k in sorted(set(sa) | set(sb)):
            same = ("only after" if k not in sa else "only before"
                    if k not in sb else "identical" if sa[k] == sb[k]
                    else "differs")
            print(f"SASS {lib} {k}: {same} ({len(sa.get(k, ()))} / "
                  f"{len(sb.get(k, ()))} instructions)")
    mean = {}
    for root in dict.fromkeys(r for r, _ in turns):
        runs = [res for r, res in turns if r == root]
        mean[root] = {k: statistics.mean(res[k] for res in runs)
                      for k in runs[0]}
    print(json.dumps(mean))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2]))
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(*sys.argv[1:]))
