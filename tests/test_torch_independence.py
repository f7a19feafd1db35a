"""The port stands alone: no file of ``src/repro_torch``, not
``chip_smoke.py`` and not ``tests/test_torch_cuda.py`` (which runs on the
card's machine) imports ``jax`` or the reference package ``repro``;
importing the port leaves jax out of ``sys.modules``; and ``chip_smoke.py``
refuses to report a result where there is no CUDA device."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "tests" / "test_torch_cuda.py"]
    assert len(files) > 20
    assert {f"src/repro_torch/obs/{m}.py" for m in (
        "__init__", "sink", "timeline", "gauges", "profiler", "metrics")} | {
        "src/repro_torch/launch/mesh.py", "src/repro_torch/data/pipeline.py",
        "src/repro_torch/core/fedavg.py",
        "src/repro_torch/launch/serve.py",
        "src/repro_torch/models/moe.py"} <= {
        str(f.relative_to(ROOT)) for f in files}
    bad = {str(f.relative_to(ROOT)): root for f in files
           for root in _imported_roots(f) if root in FORBIDDEN}
    assert bad == {}


def _run(code, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_importing_the_port_leaves_jax_out():
    out = _run("import sys\n"
               "import repro_torch.api, repro_torch.convert\n"
               "import repro_torch.kernels.quant.ops\n"
               "import repro_torch.fleet.hetero, repro_torch.configs\n"
               "import repro_torch.fleet.campaign, repro_torch.core.adaptive_cut\n"
               "import repro_torch.sim, repro_torch.sim.monte_carlo\n"
               "import repro_torch.kernels.attn.ops\n"
               "import repro_torch.kernels.rwkv.ops, repro_torch.launch.train\n"
               "import repro_torch.obs, repro_torch.obs.metrics\n"
               "import repro_torch.obs.profiler, repro_torch.obs.gauges\n"
               "import repro_torch.launch.mesh, repro_torch.data.pipeline\n"
               "import repro_torch.launch.serve, repro_torch.models.moe\n"
               "import chip_smoke\n"
               "print(sorted(m for m in sys.modules\n"
               "             if m.split('.')[0] in ('jax', 'repro')))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        return
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
