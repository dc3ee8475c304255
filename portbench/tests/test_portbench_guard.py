"""The import guard: nothing of the harness imports the JAX stack or the
JAX package; the reference imports nothing of the port; names compare by
their whole top-level part."""

import ast
import subprocess
import sys

from portbench.harness import guard, spec

SOURCES = sorted(p for p in spec.PACKAGE.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_names_compare_by_their_whole_top_level_part():
    assert guard.forbidden(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                            "phendiff_tpu", "phendiff_tpu.ops"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "phendiff_tpu",
        "phendiff_tpu.ops"]
    assert guard.forbidden(["phendiff_tpu_torch", "phendiff_tpu_torch.ops", "jaxtyping",
                            "portbench"]) == []


def test_no_harness_module_imports_jax_or_the_jax_package():
    assert SOURCES
    for path in SOURCES:
        assert not guard.forbidden(_imports(path)), path


def test_the_reference_imports_nothing_of_the_port():
    for path in (spec.PACKAGE / "reference").glob("*.py"):
        assert all(n.split(".")[0] not in ("phendiff_tpu_torch", "phendiff_tpu")
                   for n in _imports(path)), path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import runpy, sys; sys.argv = ['run.py', '--help']\n"
        "import portbench.run, portbench.control\n"
        "from portbench.harness import guard, spec\n"
        "bench = spec.load_json(spec.ROOT / 'BENCHMARK.json')\n"
        "for w in bench['workloads']:\n"
        "    c = spec.load_cell(w['name']); c.runner(); c.family()\n"
        "for m in bench['per_layer']: spec.metric_reader(m['name'])\n"
        "import phendiff_tpu_torch.pipelines.transfer, phendiff_tpu_torch.train.trainer\n"
        "import phendiff_tpu_torch.pipelines.sd_img2img, phendiff_tpu_torch.pipelines.ddim_pipeline\n"
        "print(guard.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
