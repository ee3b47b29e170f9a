"""The port's CUDA kernels on the card (marked ``gpu``; they skip where no
card is present). This file imports neither jax nor the JAX package, so it
runs on the GPU machine, where jax is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Contracts: quantize/dequantize bitwise equal to their plain versions;
masked_aggregate bitwise equal to its plain version (same ascending client
order, one rounding per product and per sum, IEEE division) and exact on
the zero-weight fallback.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.data import make_federated_classification
from repro_torch.fl import FLConfig, run_federated
from repro_torch.kernels.masked_aggregate import masked_aggregate, masked_aggregate_plain
from repro_torch.kernels.quantize import dequantize, dequantize_plain, quantize, quantize_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _x(rows, n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32))
    u = torch.from_numpy(rng.random((rows, n), dtype=np.float32))
    return x, u


@pytest.mark.parametrize("n", [6, 256, 512, 513, 143616])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_pair_bitwise_vs_plain(cuda, n, bits):
    x, u = _x(4, n, seed=n)
    for noise in (u, None):
        q, s = quantize(x.to(cuda), None if noise is None else noise.to(cuda), bits=bits)
        qp, sp = quantize_plain(x, noise, bits=bits)
        assert torch.equal(q.cpu(), qp) and torch.equal(s.cpu(), sp)
        assert torch.equal(dequantize(q, s).cpu(), dequantize_plain(qp, sp))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_masked_aggregate_vs_plain(cuda, dtype):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((30, 65539)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(((rng.random(30) < 0.5) * rng.integers(20, 400, 30)).astype(np.float32))
    fb = torch.from_numpy(rng.standard_normal(65539).astype(np.float32)).to(dtype)
    got = masked_aggregate(x.to(cuda), w.to(cuda), fb.to(cuda)).cpu()
    assert torch.equal(got, masked_aggregate_plain(x, w, fb))
    zero = masked_aggregate(x.to(cuda), torch.zeros_like(w).to(cuda), fb.to(cuda)).cpu()
    assert torch.equal(zero, fb)


def test_int8_round_runs_through_the_kernels(cuda):
    ds = make_federated_classification(n_clients=8, n_classes=4, n_features=20,
                                       samples_per_client_range=(60, 90), seed=1)
    kernels.reset_launch_counts()
    h = run_federated(ds, FLConfig(codec="int8", rounds=2, epochs=1), device=cuda)
    counts = kernels.launch_counts()
    assert all(v > 0 for v in counts.values()), counts
    assert np.isfinite(h.accuracy_mean).all()
