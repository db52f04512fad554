"""The port stands alone: it and ``chip_smoke.py`` import neither ``jax``
nor anything of ``repro``, so they run where JAX is not installed."""
import ast
import os
import subprocess
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
_SRC = _ROOT / "src"


def test_import_pulls_in_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.api, repro_torch.kernels\n"
            "import repro_torch.store, repro_torch.kernels.store_scan\n"
            "import repro_torch.core.dynamic, repro_torch.obs\n"
            "import repro_torch.dist.compression, repro_torch.store.wal\n"
            "import repro_torch.filters, repro_torch.tune\n"
            "import repro_torch.dist, repro_torch.serve, repro_torch._compat\n"
            "import repro_torch.data, repro_torch.train\n"
            "import repro_torch.models, repro_torch.configs\n"
            "import repro_torch.models.transformer, repro_torch.serve.decode\n"
            "import repro_torch.models.moe, repro_torch.models.mamba2\n"
            "import repro_torch.models.hybrid, repro_torch.models.encdec\n"
            "import repro_torch.train.optimizer, repro_torch.train.train_loop\n"
            "import repro_torch.train.fault_tolerance\n"
            "import repro_torch.dist.sharding, repro_torch.dist.pipeline\n"
            "import repro_torch.launch, repro_torch.launch.mesh\n"
            "import repro_torch.launch.cost, repro_torch.launch.dryrun\n"
            "import repro_torch.launch.profile_cell\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(_SRC)}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_importing_the_launchers_makes_no_process_group():
    """The dry run makes its fake group in ``main()``; importing it, or
    the mesh module, touches no process group."""
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.mesh\n"
            "import repro_torch.launch.profile_cell, repro_torch.dist\n"
            "assert not dist.is_initialized()\n")
    env = {**os.environ, "PYTHONPATH": str(_SRC)}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_repro():
    files = sorted((_SRC / "repro_torch").rglob("*.py"))
    names = {str(f.relative_to(_SRC / "repro_torch")) for f in files}
    assert {"store/store.py", "store/run.py", "store/compaction.py",
            "store/memtable.py", "store/faults.py", "store/integrity.py",
            "kernels/store_scan.py", "core/dynamic.py",
            "core/uint64.py", "obs/__init__.py", "obs/metrics.py",
            "obs/trace.py", "obs/fpr.py", "dist/compression.py",
            "store/wal.py", "filters/api.py", "filters/bloom.py",
            "filters/prefix_bloom.py", "filters/rosetta.py",
            "filters/surf_lite.py", "filters/cuckoo.py", "filters/minmax.py",
            "filters/bloomrf_adapter.py", "tune/workload.py", "tune/cost.py",
            "tune/solver.py", "tune/retune.py", "_compat.py",
            "dist/filter_bank.py", "dist/tenant_bank.py",
            "serve/__init__.py", "serve/prefix_cache.py",
            "data/pipeline.py", "train/checkpoint.py",
            "models/__init__.py", "models/config.py", "models/params.py",
            "models/act.py", "models/layers.py", "models/transformer.py",
            "models/registry.py", "models/moe.py", "models/mamba2.py",
            "models/hybrid.py", "models/encdec.py",
            "configs/__init__.py", "configs/base.py",
            "configs/qwen3_1_7b.py", "configs/qwen2_5_3b.py",
            "configs/qwen1_5_32b.py", "configs/granite_8b.py",
            "configs/pixtral_12b.py", "configs/granite_moe_3b_a800m.py",
            "configs/moonshot_v1_16b_a3b.py", "configs/mamba2_130m.py",
            "configs/zamba2_2_7b.py", "configs/whisper_base.py",
            "serve/kv_cache.py", "serve/decode.py", "train/__init__.py",
            "train/optimizer.py", "train/train_loop.py",
            "train/fault_tolerance.py", "dist/sharding.py",
            "dist/pipeline.py", "launch/__init__.py", "launch/mesh.py",
            "launch/cost.py", "launch/dryrun.py",
            "launch/profile_cell.py"} <= names
    files.append(_ROOT / "chip_smoke.py")
    files += sorted((_ROOT / "benchmarks").glob("torch_*.py"))
    files += sorted((_ROOT / "examples").glob("torch_*.py"))
    for f in files:
        roots = set(_imported_roots(ast.parse(f.read_text(), str(f))))
        assert not roots & {"jax", "jaxlib", "repro"}, f
