"""End-to-end example of the PyTorch port: federated pretraining of a ~100M-param
transformer across 4 silos with ACSP-FL partial model sharing — the
counterpart of ``examples/cross_silo_llm.py``, on ``repro_torch``.

    PYTHONPATH=src python examples/cross_silo_llm_torch.py --steps 200          # ~100M, on the card
    PYTHONPATH=src python examples/cross_silo_llm_torch.py --small --steps 40 --device cpu

Each silo's token stream has a different distribution (a silo-specific
token bias — the LM analogue of the paper's non-IID clients); the batches
are the JAX example's, bit for bit (``silo_batches``). Rounds alternate one
local step per silo with the masked partial aggregation of the first
``--shared`` layer periods (``repro_torch.fl.cross_silo``); upper layers
stay silo-personal. The weights are random from a ``torch.Generator``
(seed 0) and differ from the JAX example's. Reports the mean loss and the
analytic communication ledger. Runs on the CUDA card unless ``--device``
names another.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.fl.cross_silo import init_silo_opt, make_fl_round_step, silo_params_from_model
from repro_torch.models.api import get_model, param_tree
from repro_torch.models.transformer import layer_plan
from repro_torch.optim import adamw


def make_cfg(small: bool) -> ModelConfig:
    if small:
        return ModelConfig(
            name="fl-llm-8m", family="dense", n_layers=4, d_model=128,
            n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=2048, head_dim=32,
        )
    # ~100M params: 12L x 768 wide, 8k vocab
    return ModelConfig(
        name="fl-llm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=8192, head_dim=64,
    )


def silo_batches(rng, n_silos, batch, seq, vocab, step):
    """Non-IID synthetic LM data: silo i's tokens are biased Zipf over a
    silo-specific permutation of the vocab, drawn as the JAX example draws
    them (``uniform``, XLA's float32 ``log1p``, ``permutation``), on the
    key's device."""
    toks = []
    for i in range(n_silos):
        r = prng.fold_in(prng.fold_in(rng, i), step)
        # zipf-ish via clipped exponential of uniform
        u = prng.uniform(r, (batch, seq + 1))
        z = torch.clamp_max((-(prng._log1p(-u)) * vocab / (6 + 2 * i)).to(torch.int32), vocab - 1)
        perm = prng.permutation(prng.fold_in(prng.PRNGKey(777, device=rng.device), i), vocab)
        toks.append(perm[z.long()])
    t = torch.stack(toks)  # (silos, batch, seq+1)
    return {"tokens": t[:, :, :-1], "labels": t[:, :, 1:]}


def comm_ledger(cfg: ModelConfig, model, shared: int) -> tuple[int, int]:
    """(shared, total) parameters a round, as the JAX example counts them:
    ``embed`` plus ``min(shared, n_periods)`` periods of the stack."""
    sizes = {name: p.numel() for name, p in param_tree(model).items()}
    n_pro, p, n_periods = layer_plan(cfg)
    per_period = sum(n for name, n in sizes.items()
                     if name.startswith("blocks.") and n_pro <= int(name.split(".")[1]) < n_pro + p)
    return sizes["embed"] + min(shared, n_periods) * per_period, sum(sizes.values())


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200, help="total local steps (rounds x 1)")
    ap.add_argument("--silos", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2, help="per-silo batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--shared", type=int, default=None, help="layer periods aggregated (default: half)")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = make_cfg(args.small)
    bundle = get_model(cfg)
    shared = args.shared if args.shared is not None else cfg.n_layers // 2

    base = bundle.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in base.parameters())
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params, {args.silos} silos, sharing {shared}/{cfg.n_layers} layer periods")

    shared_params, full_params = comm_ledger(cfg, base, shared)
    silo = silo_params_from_model(base, args.silos)
    del base
    opt = adamw(3e-4)
    silo_opt = init_silo_opt(opt, silo)
    round_step = make_fl_round_step(cfg, bundle, opt, shared)

    # analytic comm ledger: bytes all-reduced per round = shared param bytes
    print(f"aggregated/round: {shared_params/1e6:.1f}M of {full_params/1e6:.1f}M params "
          f"({shared_params/full_params:.0%}) -> comm reduction {1-shared_params/full_params:.0%} vs full FedAvg")

    rng = prng.PRNGKey(0, device=dev)
    weights = torch.ones((args.silos,), device=dev)
    t0 = time.time()
    losses = []
    for step in range(args.steps):
        batch = silo_batches(rng, args.silos, args.batch, args.seq, cfg.vocab_padded, step)
        silo, silo_opt, loss = round_step(silo, silo_opt, batch, weights)
        losses.append(float(loss))
        if step % max(1, args.steps // 20) == 0 or step == args.steps - 1:
            print(f"  round {step:4d} mean-loss {losses[-1]:.4f} ({(time.time()-t0)/(step+1):.2f}s/round)")

    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], "no learning?"
    print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} federated rounds")
    print(f"total uplink saved vs full sharing: {(1-shared_params/full_params)*100:.0f}% x {args.steps} rounds")
    return losses


if __name__ == "__main__":
    main()
