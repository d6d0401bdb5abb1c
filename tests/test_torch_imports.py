"""The port and ``chip_smoke.py`` import and run their CPU paths with JAX,
flax and the JAX package unavailable: the card's machine has no JAX, and
the port keeps its own copies of what it needs.  Without a card,
``chip_smoke.main`` returns 1 and prints nothing on stdout."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["retinanet_tpu"] = None
import torch
torch.set_num_threads(2)
import chip_smoke
import retinanet_tpu_torch.export
import retinanet_tpu_torch.infer
from retinanet_tpu_torch.ops import bottleneck, nms

g = torch.Generator().manual_seed(0)
x = torch.randn(1, 4, 5, 64, generator=g).to(torch.bfloat16)
ks = [torch.randn(16, 64, 1, 1, generator=g), torch.ones(16), torch.zeros(16),
      torch.randn(16, 16, 3, 3, generator=g), torch.ones(16), torch.zeros(16),
      torch.randn(64, 16, 1, 1, generator=g), torch.ones(64), torch.zeros(64)]
y = bottleneck.fused_bottleneck(x, *ks)
assert y.shape == x.shape and y.dtype == torch.bfloat16
assert torch.equal(y, bottleneck.fused_bottleneck_plain(x, *ks))

c = torch.rand(2, 30, 2, generator=g)
boxes = torch.cat([c, c + 0.2], -1)
keep = nms.nms_keep_mask_batch(boxes, 0.5)
assert keep.dtype == torch.bool and keep.shape == (2, 30)
assert torch.equal(keep, nms._greedy_keep_mask(boxes, 0.5))
assert bottleneck.fused_bottleneck.launches == 0
assert nms.nms_keep_mask_batch.launches == 0

# The kernels of int8 and fused_proj serving and the opt-in B4/B7 entry
# points run their plain versions on CPU tensors and launch nothing.
from retinanet_tpu_torch.ops import groupnorm, int8_conv, stem
xc = torch.randn(1, 4, 5, 64, generator=g)
assert int8_conv.int8_conv(xc, torch.randn(64, 64, 3, 3, generator=g),
                           2).shape == (1, 2, 3, 64)
p = bottleneck.fused_bottleneck_proj(x, *ks[:6], torch.randn(
    256, 16, 1, 1, generator=g), torch.ones(256), torch.zeros(256),
    torch.randn(256, 64, 1, 1, generator=g), torch.ones(256), torch.zeros(256))
assert p.shape == (1, 4, 5, 256)
assert groupnorm.fused_group_norm_act(xc, torch.ones(64), torch.zeros(64),
                                      32, 1e-5, "elu").shape == xc.shape
assert stem.gn_relu_maxpool(x, torch.ones(1, 64),
                            torch.zeros(1, 64)).shape == (1, 2, 3, 64)
assert (int8_conv.int8_conv.launches,
        bottleneck.fused_bottleneck_proj.launches,
        groupnorm.fused_group_norm_act.launches,
        stem.gn_relu_maxpool.launches) == (0, 0, 0, 0)
assert sys.modules["jax"] is None and sys.modules["flax"] is None
assert sys.modules["retinanet_tpu"] is None

# No visible card: the smoke run refuses before it prints a result.
assert not torch.cuda.is_available()
assert chip_smoke.main() == 1
print("ok")
"""


# Every module of the port, walked from the package, with the JAX package
# itself blocked as well as jax, flax and optax.
_WALK = r"""
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax", "retinanet_tpu"):
    sys.modules[name] = None
import retinanet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(retinanet_tpu_torch.__path__,
                                               "retinanet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "optax", "retinanet_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
for name in ("train", "evaluate", "detect", "export", "native", "eval_coco",
             "eval_voc", "data.pipeline", "data.stats", "data.loaders.coco",
             "data.loaders.pascal", "data.loaders.shapes",
             "data.loaders.inferred", "data.loaders.smoke", "utils.draw",
             "utils.tb_events", "utils.summaries", "utils.pretrained",
             "utils.cli"):
    assert "retinanet_tpu_torch." + name in names, (name, names)
print(len(names))
"""


# The evaluation path's host side on a machine without JAX, cv2 or PIL, as
# the card's: shapes samples through ``evaluate_model`` on the native path
# (a stand-in detector), while reading an image file raises by name.
_NO_CODECS = r"""
import sys
for name in ("jax", "flax", "optax", "retinanet_tpu", "cv2", "PIL"):
    sys.modules[name] = None
import numpy as np
from retinanet_tpu_torch.config import Config
from retinanet_tpu_torch.data import pipeline
from retinanet_tpu_torch.data.loaders.inferred import Inferred
from retinanet_tpu_torch.eval_coco import evaluate_model

class Empty:
    def detect(self, images, scales=None):
        assert images.shape == (2, 64, 64, 3) and images.dtype == np.float32
        return [{"boxes": np.zeros((0, 4), np.float32),
                 "scores": np.zeros(0, np.float32),
                 "class_ids": np.zeros(0, np.int32)}] * len(images)

config = Config()
config = config.replace(data=config.data.__class__(image_size=64,
                                                   batch_size=2))
metrics = evaluate_model(Empty(), Inferred("shapes", ["x", "3", "64"],
                                           include_crowds=True), config)
assert metrics["mAP"] == 0.0, metrics
try:
    pipeline._imread("missing.png")
except RuntimeError as err:
    assert "cv2 or PIL" in str(err), err
else:
    raise AssertionError("_imread read without a decoder")
print("ok")
"""


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_and_runs_without_jax():
    proc = _run(_CODE)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"
    assert "no CUDA device" in proc.stderr


def test_every_port_module_imports_without_the_jax_package():
    proc = _run(_WALK)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip()) >= 20


def test_eval_host_path_runs_without_image_codecs():
    proc = _run(_NO_CODECS)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


def test_kernel_argtypes_match_the_c_signatures():
    """Each exported C function of ``ops/csrc`` takes as many parameters
    as its ``KernelLibrary`` passes (a missing ``argtypes`` entry shifts
    every later argument), and a pointer (``void*``) exactly where the
    wrapper passes ``c_void_p``.  Read from the sources: no card needed."""
    import ctypes
    import re

    from retinanet_tpu_torch.ops import (bottleneck, bottleneck_bwd,
                                         groupnorm, int8_conv, nms, stem)
    libs = (bottleneck.LIB, bottleneck.PROJ_LIB, bottleneck_bwd.LIB,
            groupnorm.LIB, int8_conv.LIB, nms.LIB, stem.LIB)
    checked = 0
    for lib in libs:
        text = lib.source.read_text()
        for name, argtypes in lib.functions.items():
            m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
            assert m, (lib.source.name, name)
            params = [p.strip() for p in m.group(1).split(",")]
            assert len(params) == len(argtypes), (name, len(params),
                                                  len(argtypes))
            for p, t in zip(params, argtypes):
                assert ("*" in p) == (t is ctypes.c_void_p), (name, p, t)
            checked += 1
    assert checked >= 8
