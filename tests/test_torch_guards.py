"""Boundaries of the PyTorch port: it imports nothing of JAX, flax or the
JAX package; chip_smoke.py refuses to run without a GPU."""
import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

from . import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "yolov3_tensorflow_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "yolov3_tensorflow_tpu")


def port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return out


def imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_or_jax_package():
    files = port_files()
    assert len(files) > 15
    for path in files:
        bad = sorted(set(imported_roots(path)) & set(FORBIDDEN))
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("checks the GPU-less behaviour")
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:  # a directory holding chip_smoke.py and nothing else
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    proc = subprocess.run([sys.executable, script], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# ------------------------------------------------- training knobs ----
def tiny_cfg(**kw):
    from yolov3_tensorflow_tpu_torch.config import Config
    return Config(input_image_size=(64, 64, 3), batch_size=2, max_boxes=4,
                  **kw)


def test_winograd_conv_backend_raises_in_training(monkeypatch):
    """At winograd_min_channels=64 a train step runs module 1's chain: its
    second block's first conv through the residual-boundary modes
    (PRO_BN_ADD forward, PRO_DYEFF + EPI_BN_ADD gradient), with nothing
    raised.  Eval runs direct convolution, as in the JAX package; an
    unknown backend raises."""
    from yolov3_tensorflow_tpu_torch.models.detector import build_detector
    from yolov3_tensorflow_tpu_torch.ops import winograd as wg
    calls = []
    original = wg.winograd_call

    def record(x, u, *args, **kw):
        calls.append((kw.get("pro"), kw.get("epi")))
        return original(x, u, *args, **kw)

    monkeypatch.setattr(wg, "winograd_call", record)
    cfg = tiny_cfg(conv_backend="winograd", winograd_min_channels=64)
    model = build_detector(cfg, "cpu").train()
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    heads = model(x)
    sum(h.sum() for h in heads).backward()
    assert calls.count((wg.PRO_BN_ADD, wg.EPI_STATS)) == 1
    assert calls.count((wg.PRO_DYEFF, wg.EPI_BN_ADD)) == 1
    assert len(calls) == 12
    assert all(torch.isfinite(h).all() for h in heads)
    calls.clear()
    assert model.eval()(torch.zeros(1, 3, 64, 64))[0].shape[0] == 1
    assert calls == []
    with pytest.raises(ValueError, match="unknown conv_backend"):
        build_detector(tiny_cfg(conv_backend="im2col"), "cpu")


@pytest.mark.parametrize("knob", [
    dict(ema_decay=0.999), dict(freeze_backbone=True), dict(is_mixup=True),
    dict(grad_accum_steps=2), dict(init_from="/nonexistent"),
    dict(multi_scale_sizes=((64, 64), (96, 96))),
    dict(spatial_partition=2), dict(is_giou_loss=True),
    dict(is_gradient_harmonized=True), dict(is_gaussian_yolo=True)])
def test_deferred_training_knobs_raise(knob):
    from yolov3_tensorflow_tpu_torch.train.trainer import YOLOv3Trainer
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        YOLOv3Trainer(tiny_cfg(**knob), "cpu")


def test_trainer_rejects_unknown_backends_and_sizes():
    from yolov3_tensorflow_tpu_torch.train.trainer import YOLOv3Trainer
    with pytest.raises(ValueError, match="augment_backend"):
        YOLOv3Trainer(tiny_cfg(augment_backend="numpy"), "cpu")
    tr = YOLOv3Trainer(tiny_cfg(augment_backend="fused"), "cpu")
    labels = -torch.ones(2, 4, 5)
    with pytest.raises(ValueError, match="uint8"):
        tr.train_step(tr.state, torch.rand(2, 64, 64, 3), labels)
    with pytest.raises(ValueError, match="multi-scale"):
        tr.train_step(tr.state, torch.zeros(2, 32, 32, 3,
                                            dtype=torch.uint8), labels)


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the GPU-less behaviour")
    from yolov3_tensorflow_tpu_torch.train.trainer import YOLOv3Trainer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        YOLOv3Trainer(tiny_cfg())


# ------------------------------------------------- pool-only stem ----
def test_v2_modules_are_among_the_checked_files():
    files = port_files()
    for rel in (("models", "resnet18_v2.py"), ("ops", "stem_pool.py"),
                ("models", "layers.py")):
        assert os.path.join(PORT, *rel) in files


def pool_calls():
    """Each pool-only wrapper, called on meta tensors of a (2, 4, 8, 8)
    input."""
    from yolov3_tensorflow_tpu_torch.ops import stem_pool as sp
    y = torch.empty(2, 4, 8, 8, device="meta")
    codes = torch.empty(2, 4, 4, 4, dtype=torch.uint8, device="meta")
    dp = torch.empty(2, 4, 4, 4, device="meta")
    return {"max_pool_s2_eval": lambda: sp.max_pool_s2_eval(y),
            "max_pool_s2_fwd": lambda: sp.max_pool_s2_fwd(y),
            "max_pool_s2_bwd": lambda: sp.max_pool_s2_bwd(codes, dp,
                                                          (8, 8))}


class _FailingLibrary:
    """A kernel library whose every launcher returns a CUDA error."""

    def __getattr__(self, name):
        if name == "yolo_cuda_error_string":
            return lambda err: b"unspecified launch failure"
        return lambda *args: 719


@pytest.mark.parametrize("failure", ["build", "launch"])
@pytest.mark.parametrize("name", ["max_pool_s2_eval", "max_pool_s2_fwd",
                                  "max_pool_s2_bwd"])
def test_pool_wrappers_raise_rather_than_fall_back(monkeypatch, name,
                                                   failure):
    """On a device tensor a pool-only wrapper launches its kernel or
    raises: a kernel library that fails to build or a launch that fails
    propagates, no launch is counted and nothing runs the plain version.
    Meta tensors stand in for CUDA ones here (the device check and the
    stream lookup are patched)."""
    from yolov3_tensorflow_tpu_torch.ops import stem_pool as sp

    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran on a device tensor")

    def failed_build():
        raise RuntimeError("kernel build failed: nvcc error")

    monkeypatch.setattr(sp, "_check_cuda_args", lambda *args: None)
    monkeypatch.setattr(sp, "_stream", lambda t: 0)
    monkeypatch.setattr(sp, "max_pool_s2_reference", no_plain)
    monkeypatch.setattr(sp, "max_pool_s2_bwd_reference", no_plain)
    monkeypatch.setattr(sp, "kernel_library",
                        failed_build if failure == "build"
                        else _FailingLibrary)
    wrapper = getattr(sp, name)
    before = wrapper.launches
    match = "build failed" if failure == "build" else \
        f"{name} failed to launch: unspecified launch failure"
    with pytest.raises(RuntimeError, match=match):
        pool_calls()[name]()
    assert wrapper.launches == before


@pytest.mark.parametrize("name", ["max_pool_s2_eval", "max_pool_s2_fwd",
                                  "max_pool_s2_bwd"])
def test_pool_wrappers_refuse_other_devices(name):
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pool_calls()[name]()


# ----------------------------------------------------- winograd ----
def test_winograd_modules_are_among_the_checked_files():
    files = port_files()
    for rel in (("ops", "winograd.py"), ("models", "resnet18.py"),
                ("models", "layers.py"), ("models", "detector.py"),
                ("train", "trainer.py"), ("tools", "profile_train.py")):
        assert os.path.join(PORT, *rel) in files


def winograd_call_on_meta(mode):
    """The Winograd wrapper in ``mode`` on meta tensors of a (2, 8, 6, 6)
    input with 8 output channels."""
    from yolov3_tensorflow_tpu_torch.ops import winograd as wg
    x = torch.empty(2, 8, 6, 6, dtype=torch.bfloat16, device="meta")
    u = torch.empty(16, 8, 8, dtype=torch.bfloat16, device="meta")
    scal = torch.empty(2, 8, device="meta")
    pro, epi = mode
    return wg.winograd_call(x, u, partner=x, cvals=x, avals=x, dvals=x,
                            scal=scal, scal2=scal, pro=pro, epi=epi,
                            aux=pro != wg.PRO_NONE)


def winograd_modes():
    from yolov3_tensorflow_tpu_torch.ops.winograd import MODES
    return list(MODES)


@pytest.mark.parametrize("failure", ["build", "launch"])
@pytest.mark.parametrize("mode", winograd_modes(), ids=str)
def test_winograd_wrapper_raises_rather_than_falls_back(monkeypatch, mode,
                                                        failure):
    """On a device tensor the Winograd wrapper launches its kernel or
    raises: a failed build or launch propagates, no launch is counted and
    the plain version never runs (meta tensors stand in for CUDA ones)."""
    from yolov3_tensorflow_tpu_torch.ops import winograd as wg

    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran on a device tensor")

    def failed_build():
        raise RuntimeError("kernel build failed: nvcc error")

    monkeypatch.setattr(wg, "_check_cuda_args", lambda *args: None)
    monkeypatch.setattr(wg, "_stream", lambda t: 0)
    monkeypatch.setattr(wg, "winograd_reference", no_plain)
    monkeypatch.setattr(wg, "kernel_library",
                        failed_build if failure == "build"
                        else _FailingLibrary)
    before = {m: k.launches for m, k in wg.KERNELS.items()}
    match = "build failed" if failure == "build" else \
        "winograd_call .* failed to launch: unspecified launch failure"
    with pytest.raises(RuntimeError, match=match):
        winograd_call_on_meta(mode)
    assert {m: k.launches for m, k in wg.KERNELS.items()} == before


@pytest.mark.parametrize("mode", winograd_modes(), ids=str)
def test_winograd_wrapper_refuses_other_devices(mode):
    with pytest.raises(ValueError, match="no kernel for device meta"):
        winograd_call_on_meta(mode)


@pytest.mark.parametrize("backbone", ["resnext-18", "mixnet-18",
                                      "mobilenet-v2"])
def test_unported_backbones_raise(backbone):
    from yolov3_tensorflow_tpu_torch.models.detector import build_detector
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_detector(tiny_cfg(model_backbone=backbone), "cpu")
