"""Import rules of the PyTorch port, checked in fresh interpreters.

* No module of ``de_i2i_gan_torch`` (nor ``chip_smoke.py``, nor the card's
  ``tests/test_torch_kernel_gpu.py``) pulls in jax, flax, optax or any
  module of ``de_i2i_gan_tpu``.
* Importing the CUDA kernel module neither needs nor runs ``nvcc``, and
  importing the native loader neither needs nor runs ``g++``: each builds
  at first use.
* Importing the entry points (``cli/*``, the MAE, pix2pix and WGAN ones
  among them), the input feeds (``data``, ``runtime``), MAE pretraining
  (``train/mae_steps.py``, ``utils/masks.py``), pix2pix and WGAN
  (``train/pix2pix_steps.py``, ``train/wgan_steps.py``,
  ``train/remat.py``, ``data/paired.py``) and StarGAN v2
  (``models/starganv2.py``, ``train/solver.py``,
  ``data/starganv2_data.py``, ``utils/translate.py``), serving
  (``serving.py``, ``cli/export_model.py``, ``cli/translate_folder.py``)
  and the metrics (``cli/fid.py``, ``metrics/eval_starganv2.py``), data
  parallelism and height-sharded inference (``parallel/``), the reference
  checkpoint import (``train/torch_import.py``) and the tools
  (``utils/profiling.py``, ``cli/sweep.py``) parses no arguments, starts no
  thread, joins no process group and writes nothing.
"""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "de_i2i_gan_tpu")


def _run(code: str, **env) -> subprocess.CompletedProcess:
    full_env = {**os.environ, "PYTHONPATH": str(ROOT), **env}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full_env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


def test_port_imports_nothing_of_jax():
    code = f"""
import ast, importlib, pkgutil, sys
import de_i2i_gan_torch
names = ["de_i2i_gan_torch"] + [m.name for m in pkgutil.walk_packages(
    de_i2i_gan_torch.__path__, "de_i2i_gan_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 40, names
for want in ("cli.train_defectgan", "cli.test_defectgan", "config.options",
             "data.pipeline", "data.datasets", "data.synthetic",
             "data.transforms", "data.embeddings", "metrics.evaluator",
             "train.checkpoint", "train.trainer", "utils.guards",
             "utils.seed", "utils.png", "runtime.native_loader",
             "models.starganv2", "train.solver", "cli.starganv2_main",
             "data.starganv2_data", "utils.translate", "utils.visualize",
             "cli.train_mae", "cli.test_mae", "cli.train_mtvec",
             "cli.pretrain_mtvec", "train.mae_steps", "utils.masks",
             "data.paired", "train.pix2pix_steps", "train.wgan_steps",
             "train.remat", "cli.train_pix2pix", "cli.test_pix2pix",
             "cli.train_wgan", "serving", "cli.export_model",
             "cli.translate_folder", "cli.fid", "metrics.inception",
             "metrics.lpips", "metrics.fid", "metrics.eval_starganv2",
             "parallel.distributed", "parallel.mesh", "utils.profiling",
             "cli.sweep", "parallel.spatial", "train.torch_import"):
    assert "de_i2i_gan_torch." + want in names, want
# the files that run on the card only: check their imports statically
card = set()
for path in ("chip_smoke.py", "tests/test_torch_kernel_gpu.py"):
    tree = ast.parse(open(path).read())
    card |= {{a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
              for a in n.names}}
    card |= {{n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}}
bad = sorted(m for m in list(sys.modules) + sorted(card)
             if m.split(".")[0] in {FORBIDDEN!r})
assert not bad, bad
print(len(names))
"""
    _run(code)


def test_kernel_module_import_needs_no_nvcc():
    code = """
import subprocess
def refuse(*a, **k):
    raise AssertionError("a process was started at import")
subprocess.run = subprocess.Popen = refuse
from de_i2i_gan_torch.ops.cuda import norm_kernels
from de_i2i_gan_torch.ops import fused
from de_i2i_gan_torch.runtime import native_loader
import de_i2i_gan_torch.train.steps
import de_i2i_gan_torch.train.solver
import de_i2i_gan_torch.cli.train_defectgan
import de_i2i_gan_torch.cli.starganv2_main
import de_i2i_gan_torch.cli.train_mae
import de_i2i_gan_torch.train.mae_steps
import de_i2i_gan_torch.cli.train_pix2pix
import de_i2i_gan_torch.cli.test_pix2pix
import de_i2i_gan_torch.cli.train_wgan
import de_i2i_gan_torch.train.pix2pix_steps
import de_i2i_gan_torch.train.wgan_steps
import de_i2i_gan_torch.serving
import de_i2i_gan_torch.cli.export_model
import de_i2i_gan_torch.cli.translate_folder
import de_i2i_gan_torch.metrics.evaluator
assert norm_kernels._fn is None and norm_kernels.LAUNCHES == 0
assert native_loader._lib is None
"""
    _run(code, PATH="/nonexistent", CUDA_HOME="/nonexistent")


def test_entry_points_import_without_side_effects(tmp_path):
    code = """
import os, sys, threading
sys.argv = ["x", "--bogus", "--ckpt_dir", "made_at_import"]
import de_i2i_gan_torch.cli.train_defectgan
import de_i2i_gan_torch.cli.test_defectgan
import de_i2i_gan_torch.data.pipeline
import de_i2i_gan_torch.train.trainer
import de_i2i_gan_torch.runtime.native_loader
import de_i2i_gan_torch.models.starganv2
import de_i2i_gan_torch.train.solver
import de_i2i_gan_torch.cli.starganv2_main
import de_i2i_gan_torch.data.starganv2_data
import de_i2i_gan_torch.utils.translate
import de_i2i_gan_torch.cli.train_mae
import de_i2i_gan_torch.cli.test_mae
import de_i2i_gan_torch.cli.train_mtvec
import de_i2i_gan_torch.cli.pretrain_mtvec
import de_i2i_gan_torch.train.mae_steps
import de_i2i_gan_torch.utils.masks
import de_i2i_gan_torch.cli.train_pix2pix
import de_i2i_gan_torch.cli.test_pix2pix
import de_i2i_gan_torch.cli.train_wgan
import de_i2i_gan_torch.data.paired
import de_i2i_gan_torch.train.pix2pix_steps
import de_i2i_gan_torch.train.wgan_steps
import de_i2i_gan_torch.train.remat
import de_i2i_gan_torch.serving
import de_i2i_gan_torch.cli.export_model
import de_i2i_gan_torch.cli.translate_folder
import de_i2i_gan_torch.cli.fid
import de_i2i_gan_torch.metrics.eval_starganv2
import de_i2i_gan_torch.parallel.distributed
import de_i2i_gan_torch.parallel.mesh
import de_i2i_gan_torch.parallel.spatial
import de_i2i_gan_torch.train.torch_import
import de_i2i_gan_torch.utils.profiling
import de_i2i_gan_torch.cli.sweep
import torch.distributed
assert not torch.distributed.is_initialized()
assert threading.active_count() == 1, threading.enumerate()
assert os.listdir(".") == [], os.listdir(".")
"""
    full_env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=full_env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
