"""Nothing the benchmark runs reaches JAX or the JAX package, and the plain
reference reaches nothing of the program either (top-level names compared
whole: the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHECKOUT = ROOT.parent
JAX = {"jax", "jaxlib", "flax", "nerf_fusion_tpu"}


def _imports(path: Path):
    """(top-level name, level, module) of every import in a file, those
    inside functions included."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], 0, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            out.append((mod.split(".")[0], node.level, mod))
    return out


def _reach(start: Path, base: Path, package: str) -> set:
    """Top-level names reached from ``start``, following the imports inside
    ``package`` (rooted at ``base``) file by file."""
    seen, todo, names = set(), [start], set()
    while todo:
        f = todo.pop()
        if f in seen or not f.exists():
            continue
        seen.add(f)
        for top, level, mod in _imports(f):
            if level:
                d = f.parent
                for _ in range(level - 1):
                    d = d.parent
                target = d.joinpath(*mod.split(".")) if mod else d
            elif top == package:
                target = base.joinpath(*mod.split("."))
            else:
                names.add(top)
                continue
            names.add(package)
            for cand in (target.with_suffix(".py"), target / "__init__.py"):
                todo.append(cand)
            if target.is_dir():
                todo += list(target.glob("*.py"))
    return names


def test_reference_reaches_neither_jax_nor_the_program():
    for f in sorted((ROOT / "reference").glob("*.py")):
        names = _reach(f, CHECKOUT, "fusion_bench")
        assert not names & (JAX | {"nerf_fusion_tpu_torch"}), (f.name, names)


def test_benchmark_files_reach_no_jax():
    files = [f for f in ROOT.rglob("*.py") if "tests" not in f.parts]
    for f in files:
        assert not {t for t, _, _ in _imports(f)} & JAX, f


def test_program_reaches_no_jax():
    """The port as the harness drives it, followed statically."""
    pkg = CHECKOUT / "nerf_fusion_tpu_torch"
    names = set()
    for f in pkg.rglob("*.py"):
        names |= {t for t, _, _ in _imports(f)}
    assert not names & JAX


def test_loaded_modules_after_import():
    """Importing the harness, the check, the metric readers and the port's
    fusion loop loads no JAX module (a fresh interpreter)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import fusion_bench.harness, fusion_bench.check, fusion_bench.metrics_io\n"
        "import fusion_bench.control, fusion_bench.kernels\n"
        "from fusion_bench import discovery\n"
        "for m in discovery.benchmark()['per_layer']: discovery.metric_reader(m['name'])\n"
        "import nerf_fusion_tpu_torch.system.pipeline, nerf_fusion_tpu_torch.models.io\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % str(CHECKOUT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(CHECKOUT))
    assert out.returncode == 0, out.stderr
    assert not set(eval(out.stdout.strip().splitlines()[-1])) & JAX


def test_banned_names_are_compared_whole():
    from fusion_bench import harness

    sys.modules.setdefault("nerf_fusion_tpu_torch_probe_only", sys)
    try:
        assert "nerf_fusion_tpu" not in harness.banned_modules()
    finally:
        del sys.modules["nerf_fusion_tpu_torch_probe_only"]
