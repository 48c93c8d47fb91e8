"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests need an NVIDIA GPU (marker ``gpu``) and skip without
one.  The card's machine has no JAX, so this file imports none and runs
without the suite's conftest:

    python -m pytest tests/test_torch_cuda_kernels.py -m gpu --noconftest -q
"""
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu_torch.ops.stem_pool import (
    bn_pool_relu_eval, bn_pool_relu_eval_reference)


def stem_case(n, c, h, w, kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "ties":
        y = ((np.arange(n * c * h * w) % 5) - 2).reshape(n, c, h, w) * 0.5
    else:
        y = rng.randn(n, c, h, w)
    inv = rng.rand(c) + 0.5
    shift = rng.randn(c) * 0.3
    if kind == "negative":
        y, shift = -np.abs(y) - 0.01, -np.abs(shift)
    if kind == "inv0":
        inv[c // 2] = 0.0
    return (torch.tensor(y, dtype=torch.bfloat16, device="cuda"),
            torch.tensor(inv, dtype=torch.float32, device="cuda"),
            torch.tensor(shift, dtype=torch.float32, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind", [
    ((4, 8, 16, 8), "randn"), ((2, 4, 13, 11), "ties"),
    ((2, 8, 16, 16), "inv0"), ((2, 4, 8, 8), "negative"),
    ((2, 64, 208, 208), "randn")])
def test_stem_kernel_bit_equals_plain_version(shape, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    y, inv, shift = stem_case(*shape, kind, seed=2)
    before = bn_pool_relu_eval.launches
    got = bn_pool_relu_eval(y, inv, shift)
    want = bn_pool_relu_eval_reference(y, inv, shift)
    torch.cuda.synchronize()
    assert bn_pool_relu_eval.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.gpu
def test_stem_kernel_rejects_bad_scalars():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    y = torch.zeros(1, 4, 8, 8, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        bn_pool_relu_eval(y, torch.ones(4, device="cuda").half(),
                          torch.zeros(4, device="cuda"))
    with pytest.raises(ValueError, match="shape"):
        bn_pool_relu_eval(y, torch.ones(3, device="cuda"),
                          torch.zeros(3, device="cuda"))
