"""The port's public surface against the JAX package's, read from the
sources (no JAX, nothing imported): every public top-level name of every
module of ``ocean_bgc_tpu/`` exists in its counterpart in
``ocean_bgc_tpu_torch/`` (the same path), or stands in :data:`SET_ASIDE`
with the reason the port leaves it out."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "ocean_bgc_tpu", ROOT / "ocean_bgc_tpu_torch"

# (module, name) -> why the port has no such name; name "*" sets aside the
# whole module
SET_ASIDE = {
    ("ops/pallas_carbonate.py", "*"):
        "K1's Pallas module: its kernel is csrc/carbonate_dual.cu and "
        "csrc/carbonate_coeffs.cu, its wrappers ops/cuda_carbonate.py",
    ("ops/pallas_step.py", "*"):
        "K2's Pallas module: its kernel is csrc/interior_step.cu, its "
        "wrapper ops/cuda_step.py (fused_interior_step, FusedInteriorOut); "
        "par_field_mxu is a triangular matmul because Mosaic has no cumprod",
    ("ops/particulates.py", "scalelength_explicit"):
        "exists only so that the Mosaic step lowers (particulates.py:"
        "134-149); K2 reads the scale length's dissolution factors "
        "(precompute_dissolution) as inputs",
    ("ops/bgc.py", "resolve_carbonate_impl"):
        "picks Pallas by TPU backend; the port's carbonate_impl argument "
        "and the device of its tensors choose the route",
    ("models/coupled.py", "resolve_interior_impl"):
        "picks Pallas by TPU backend; the port's interior_impl argument "
        "chooses the route",
    ("parallel/sharding.py", "make_pjit_step"):
        "a validation twin of XLA's partitioner (pjit); torch has none",
    ("parallel/sharding.py", "make_pjit_forced_run"):
        "a validation twin of XLA's partitioner (pjit); torch has none",
    ("parallel/sharding.py", "col_sharding_tree"):
        "a jax.sharding layout tree; a torch rank holds its column block "
        "(shard_columns)",
    ("utils/profiling.py", "cost_summary"):
        "reads XLA's cost analysis, which torch has no counterpart of",
    ("ops/carbonate.py", "talk_fast"):
        "OBGC_FAST_F64: works around the TPU's software-emulated f64 "
        "division; the H100 divides in f64 hardware",
    ("ops/carbonate.py", "co3_terms_dual"):
        "the XLA dual solve with its H-space brackets; the port solves the "
        "dual on K1 from the pH-space window (ops/cuda_carbonate.py::"
        "co3_terms_dual_coeffs)",
    ("ops/carbonate.py", "solve_htotal_warm"):
        "the trusted-bracket skip, which the port does not have (ROADMAP "
        "queue 3, handled #4); its seed is solve_htotal's x0",
}


def _names(path, with_imports=False):
    """The public names bound at the top level of ``path`` (functions,
    classes, assignments; with ``with_imports``, imported names too),
    inside top-level ``if`` and ``try`` blocks as well."""
    names = set()

    def bind(target):
        if isinstance(target, ast.Name):
            names.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for t in target.elts:
                bind(t)

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    bind(t)
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                bind(node.target)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                if with_imports:
                    names.update((a.asname or a.name).split(".")[0]
                                 for a in node.names)
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                for part in (node.body, node.orelse, node.finalbody,
                             *(h.body for h in node.handlers)):
                    visit(part)
    visit(ast.parse(path.read_text()).body)
    return {n for n in names if not n.startswith("_")}


def _modules():
    return sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def test_every_reference_module_has_its_counterpart():
    """Each module of the JAX package has a module of the same path in
    the port, unless the whole module is set aside."""
    missing = [m for m in _modules() if not (PORT / m).exists()
               and (m, "*") not in SET_ASIDE]
    assert not missing, missing


def test_every_public_name_is_ported_or_set_aside():
    """Every public top-level name of every JAX module is bound at the
    top level of its counterpart (defined or imported there), or is set
    aside with its reason."""
    missing = []
    for m in _modules():
        if (m, "*") in SET_ASIDE:
            continue
        ported = _names(PORT / m, with_imports=True)
        missing += [f"{m}:{n}" for n in sorted(_names(REF / m))
                    if n not in ported and (m, n) not in SET_ASIDE]
    assert not missing, missing


def test_set_aside_names_are_the_references_and_not_the_ports():
    """The list holds nothing stale: each set-aside name is the JAX
    package's (or its module is), the port has none of it, and each
    carries a reason."""
    for (module, name), why in SET_ASIDE.items():
        assert why.strip(), (module, name)
        assert (REF / module).exists(), module
        if name == "*":
            assert not (PORT / module).exists(), module
        else:
            assert name in _names(REF / module), (module, name)
            assert name not in _names(PORT / module, with_imports=True), (
                module, name)
