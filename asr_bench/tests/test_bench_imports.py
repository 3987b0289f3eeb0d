"""What the benchmark loads: no JAX and no JAX package anywhere, and nothing
of the program in the reference (top-level module names compared whole)."""

import ast
import glob
import os
import subprocess
import sys
import types

from asr_bench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "e2e_asr_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(spec.HERE, "reference", "*.py"))
    assert files
    for f in files:
        tops = set(_imports(f))
        assert not tops & (FORBIDDEN | {"e2e_asr_tpu_torch"}), f


def test_no_file_of_the_benchmark_imports_jax():
    for f in glob.glob(os.path.join(spec.HERE, "**", "*.py"), recursive=True):
        assert not set(_imports(f)) & FORBIDDEN, f


def test_the_run_path_loads_no_jax():
    code = ("import sys, asr_bench.run, asr_bench.cells, asr_bench.control\n"
            "from asr_bench import spec\n"
            "for m in spec.benchmark()['per_layer']: spec.metric_reader(m['name'])\n"
            "import e2e_asr_tpu_torch.bin.test_asr, e2e_asr_tpu_torch.training.step_graph\n"
            "import e2e_asr_tpu_torch.decode.beam_graph, e2e_asr_tpu_torch.data.prefetch\n"
            "print(','.join(asr_bench.run.forbidden_modules()))")
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "e2e_asr_tpu_torch_extra", types.ModuleType("e2e_asr_tpu_torch_extra"))
    assert "e2e_asr_tpu" not in run.forbidden_modules() or "e2e_asr_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "e2e_asr_tpu.fake", types.ModuleType("e2e_asr_tpu.fake"))
    assert "e2e_asr_tpu" in run.forbidden_modules()
