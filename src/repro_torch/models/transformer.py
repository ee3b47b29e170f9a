"""Decoder stack of the port's serving slice: falcon-mamba-7b (Mamba-1
blocks), the dense GQA + SwiGLU models (granite-3-8b; chatglm3-6b with half
RoPE; stablelm-12b; qwen2-vl-2b with M-RoPE and the vision stub), the MoE
family (deepseek-moe-16b and moonshot-v1-16b-a3b: GQA with a dense first
layer and MoE layers after it; deepseek-v2-lite-16b: the same with MLA) and
the hybrid jamba-v0.1-52b (Mamba-1 layers with one GQA layer in every
period of 8, each mixer followed by a dense SwiGLU or, every other layer,
an MoE with no shared experts). The encoder-decoder (whisper-tiny) is
``models/whisper.py``.

The model is an ``nn.Module``, ``DecoderLM``: the embedding, one block per
layer in an ``nn.ModuleList``, the final norm, the head and, under the
vision stub, ``vision_proj``: precomputed vision embeddings (B, nv, D) are
projected by it and prepended to the token embeddings, and the positions are
the (B, nv + S, 3) M-RoPE streams of the joined sequence. Its parameters
carry no gradients until a train step asks for them (``make_train_step``
turns them on; serving runs under ``torch.no_grad``). The JAX package stacks
the layers of each period and scans over them (``layer_plan``: a prologue of
unscanned layers, then periods); here the blocks are kept per layer and the
stack is a Python loop, so a cache is one dict per layer, a Mamba layer's
``{conv, ssm}`` beside an attention layer's ``{k, v, kv_pos}`` (MLA:
``{c_kv, k_rope, kv_pos}``) in a hybrid stack:

    cache = {"layers": [block_cache, ...], "pos": int}

Each layer follows its ``LayerSpec``: the mixer (``attn``, which is GQA or
MLA by ``cfg.attn_type``, or ``mamba``) and whether its FFN is the MoE; a
Mamba block has no FFN where the config has no ``d_ff`` and is not an MoE
layer (falcon-mamba). With ``cfg.tie_embeddings`` the model has no head:
the logits are ``x @ embed.T``, as in the JAX package.

A prefill given a ``cache`` continues it as the JAX forward does: each
Mamba layer's conv and scan start from its carried state, while each
attention layer ignores its cache and starts a fresh one at positions
0..S-1 (the JAX layers' behaviour, kept for parity); the new cache's
``pos`` is this call's S.

Training: ``forward(mode="train")`` runs the prefill's path without a
cache, under autograd, each block under ``torch.utils.checkpoint``
(non-reentrant) where JAX wraps it in ``jax.checkpoint`` (``remat``): its
activations are recomputed in the backward, so an attention layer's
flash_attention forward kernel runs twice a step and its backward kernel
once, and a Mamba layer's ssm_scan likewise. ``lm_loss`` is the JAX
package's loss and ``make_train_step`` its step over the port's optimizers
(``repro_torch.optim``) on ``param_tree(model)``, updating the model's
parameters in place.

Under ``launch.context.mesh_context`` the steps keep the JAX steps'
contract, global batch in and global logits (or the global loss) out, on
every rank: each rank runs its data shard of the batch
(``context.data_rows``: where the data axes divide B and the MoE, if any,
is expert-parallel, else the whole batch), the MoE layers are
expert-parallel where the ``model`` axis divides the experts, and the
(B_loc, V) logits are all-gathered over the data axes; the cache stays the
rank's shard. ``init_params`` keeps the rank's experts and, on a ``model``
axis over 1, the rank's tensor-parallel block of every other leaf
(``launch/tp.py``: the layers compute their share and sum it over
``model``; the embedding's d columns and the head's V columns are
all-gathered, the head's at the last position only at prefill, and over
``model`` before the data axes), and for training (``zero=True``) of that
block the rank's ZeRO block over the data axes (``launch/zero.py``),
which ``apply_block`` and the embedding and head gather at use;
``init_cache`` sizes the rank's shard (its rows, kv heads and d_inner).
The train step differentiates ``lm_objective``'s rank share of the global
loss and updates the rank's blocks (``apply_train_step``): the ``model``
ranks of a data shard compute the same share, and TP's collectives carry
the backward without summing a gradient over ``model``.

Under ``mesh_context(seq_parallel=True)`` a train step whose stream of S
positions the ``model`` axis divides (``context.seq_split``, JAX's rule)
takes JAX's sequence-parallel layout: the embedded stream is split into
each ``model`` rank's S/n tokens (``tp.sp_split``), every block's norms
and residual adds run on them and its checkpointed input is (B_loc, S/n,
D), each mixer and FFN gathers them along S and reduce-scatters its row
product back (``launch/tp.py``), and the final norm too runs on the
rank's tokens before one gather gives the head and the loss whole rows:
the norm's work is split like the blocks' and every norm's gradient is
then a share, which the step sums over ``model`` with the others
(``seq_norms``, ``zero.reduce_grads``). Prefill, decode and whisper never
split, as JAX's blocks apply the layout in train mode only.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import context as ctx
from repro_torch.launch import tp
from repro_torch.launch import zero as Z
from repro_torch.cost import is_fake
from repro_torch.launch.sharding import model_block
from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str   # 'attn' (gqa/mla by cfg) | 'mamba'
    moe: bool


def layer_specs(cfg: ModelConfig) -> list[LayerSpec]:
    """Each layer's spec in order (a dense first layer under
    ``first_dense``, MoE layers by ``cfg.is_moe_layer``)."""
    return [LayerSpec("mamba" if cfg.ssm and not cfg.is_attn_layer(i) else "attn",
                      cfg.is_moe_layer(i)) for i in range(cfg.n_layers)]


def period_len(cfg: ModelConfig) -> int:
    """Repeating unit length after the prologue (the JAX package's)."""
    p = 1
    if cfg.ssm and cfg.attn_period:
        p = cfg.attn_period
    if cfg.moe and cfg.moe_every > 1:
        p = p * cfg.moe_every // math.gcd(p, cfg.moe_every)
    return p


def layer_plan(cfg: ModelConfig) -> tuple[int, int, int]:
    """How the JAX package lays the layers out in its parameter tree:
    (prologue length, period length p, number of periods). The prologue
    holds the ``first_dense`` layers and the ragged tail of the body that
    is not a whole number of periods; layer ``len(prologue) + i * p + j`` is
    period entry j at index i of the stack."""
    body = cfg.n_layers - cfg.first_dense
    p = period_len(cfg)
    n_pro = cfg.first_dense + body % p
    return n_pro, p, (cfg.n_layers - n_pro) // p


def check_supported(cfg: ModelConfig) -> None:
    """Raise for an encoder-decoder config, which is ``models/whisper.py``'s
    (``api.get_model`` routes it there)."""
    if cfg.encoder_decoder:
        raise ValueError(f"{cfg.name}: an encoder-decoder config is models/whisper.py's")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _param(t: torch.Tensor) -> nn.Parameter:
    """``t`` as a parameter (a ZeRO block, ``zero.shard``'s, as it is)."""
    return t if isinstance(t, nn.Parameter) else nn.Parameter(t, requires_grad=False)


class ParamTree(nn.Module):
    """A nested dict of parameters as a module: tensors become parameters,
    dicts nested ``ParamTree``s. Indexed like the JAX package's dicts
    (``blk["mixer"]``, ``blk["moe"]["shared"]["wg"]``, ``"ffn" in blk``,
    ``.items()``). One block is the pre-norm residual layer's ``norm1``,
    ``mixer`` and, after attention (and after a Mamba mixer in jamba),
    ``norm2`` with ``ffn`` or ``moe``. ``zero_split``: some leaf is a ZeRO
    block split over the data axes (``launch/zero.py``), read once here so
    that ``apply_block`` tests one flag a step."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(name, _param(value))
        self.zero_split = any(getattr(p, "zero_dim", None) is not None for p in self.parameters())

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def keys(self) -> list[str]:
        return [*self._parameters, *self._modules]

    def items(self) -> list:
        return [(k, self[k]) for k in self.keys()]


class DecoderLM(nn.Module):
    """A decoder-only LM: ``embed`` (V_padded, D), ``blocks``,
    ``final_norm`` (D,), ``head`` (D, V_padded; None under tied embeddings,
    whose logits read ``embed``), and ``vision_proj`` (D, D) under the
    vision stub."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.specs = layer_specs(cfg)
        if len(tree["blocks"]) != len(self.specs):
            raise ValueError(f"{cfg.name}: {len(tree['blocks'])} blocks for {len(self.specs)} layers")
        if cfg.tie_embeddings == ("head" in tree):
            raise ValueError(f"{cfg.name}: tie_embeddings={cfg.tie_embeddings} and "
                             f"{'a' if 'head' in tree else 'no'} head")
        self.embed = _param(tree["embed"])
        self.final_norm = _param(tree["final_norm"])
        self.head = None if cfg.tie_embeddings else _param(tree["head"])
        if (cfg.frontend == "vision_stub") != ("vision_proj" in tree):
            raise ValueError(f"{cfg.name}: frontend {cfg.frontend!r} and "
                             f"{'a' if 'vision_proj' in tree else 'no'} vision_proj")
        if "vision_proj" in tree:
            self.vision_proj = _param(tree["vision_proj"])
        self.blocks = nn.ModuleList(ParamTree(b) for b in tree["blocks"])

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ---------------------------------------------------------------------------
# block init / apply
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec) -> dict:
    dt = L.torch_dtype(cfg)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt, device=gen.device)  # noqa: E731
    p = {"norm1": ones()}
    if spec.kind == "mamba":
        p["mixer"] = L.init_mamba(gen, cfg)
        if spec.moe:
            p["norm2"] = ones()
            p["moe"] = L.init_moe(gen, cfg)
        elif cfg.d_ff:  # jamba: a dense FFN on its non-MoE layers
            p["norm2"] = ones()
            p["ffn"] = L.init_swiglu(gen, cfg)
        return p
    p["mixer"] = L.init_mla(gen, cfg) if cfg.attn_type == "mla" else L.init_gqa(gen, cfg)
    p["norm2"] = ones()
    if spec.moe:
        p["moe"] = L.init_moe(gen, cfg)
    else:
        p["ffn"] = L.init_swiglu(gen, cfg)
    return p


def apply_block(p, x, positions, cfg: ModelConfig, spec: LayerSpec, *, cache=None,
                window: int = 0, mode: str = "prefill", by_position: bool = False,
                seq: bool = False):
    """Pre-norm residual block. Returns (x, new_cache, aux_loss), the aux
    loss None without an MoE FFN. ``by_position``: GQA masks by the t
    stream (``gqa_attention``). Under a mesh the block's ZeRO blocks are
    gathered here, inside the checkpointed function (``zero.gathered``).
    ``seq``: ``x`` is this rank's tokens of a sequence-parallel stream
    (module docstring); the norms and residual adds run on them, and the
    mixer and the FFN or MoE take them in and give theirs back."""
    p = Z.gathered(p)
    aux = None
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.kind == "mamba":
        mixed, new_cache = L.mamba_block(p["mixer"], h, cfg, cache=cache, mode=mode, seq=seq)
    elif cfg.attn_type == "mla":
        mixed, new_cache = L.mla_attention(p["mixer"], h, positions, cfg, cache=cache,
                                           window=window, mode=mode, seq=seq)
    else:
        mixed, new_cache = L.gqa_attention(p["mixer"], h, positions, cfg, cache=cache,
                                           window=window, mode=mode, by_position=by_position,
                                           seq=seq)
    x = x + mixed
    if "moe" in p:
        h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        y, aux = L.moe_apply(p["moe"], h2, cfg, seq=seq)
        x = x + y
    elif "ffn" in p:
        h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + L.swiglu(p["ffn"], h2, cfg.d_ff, seq=seq)
    return x, new_cache, aux


def init_block_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, seq: int, window: int,
                     device=None):
    """A layer's empty cache; under a tensor-parallel mesh context, the
    rank's kv heads or d_inner channels (MLA's compressed cache whole)."""
    if spec.kind == "mamba":
        return L.init_mamba_cache(cfg, batch, device, tp.d_inner(cfg))
    if cfg.attn_type == "mla":
        return L.init_mla_cache(cfg, batch, seq, window, device)
    return L.init_gqa_cache(cfg, batch, seq, window, device, tp.kv_heads(cfg))


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig, zero: bool = False) -> DecoderLM:
    """A model with random weights drawn from ``gen`` on its device: the
    JAX init's shapes, dtypes and scales (normal * 0.02, out-projections
    / sqrt(2 L), A_log, dt_bias = -4.6, a float32 router, ...), not its
    bits. Under a mesh the draws are the same and each expert leaf keeps
    this rank's experts (``layers.init_moe``); on a ``model`` axis over 1
    (``context.tensor_parallel``) each other leaf is cut to this rank's
    tensor-parallel block as soon as it is drawn (``launch/tp.hold``), and
    with ``zero`` (training under a mesh) to this rank's 2-D block, the
    ZeRO block of that (``launch/zero.shard``); a block's leaves at a time
    are whole."""
    check_supported(cfg)
    dt = L.torch_dtype(cfg)
    v, d = cfg.vocab_padded, cfg.d_model
    if zero and ctx.get_mesh() is None:
        raise ValueError("init_params(zero=True) splits the leaves over the data axes of the "
                         "open mesh_context, and none is open")

    def held(path, tree):
        if zero:
            return Z.shard(tree, path, cfg)
        return tp.hold(tree, path, cfg, ctx.get_mesh()) if ctx.tensor_parallel() else tree

    tree = {
        "embed": held("embed", L._normal(gen, (v, d), 0.02, dt)),
        "final_norm": held("final_norm", torch.ones((d,), dtype=dt, device=gen.device)),
    }
    if not cfg.tie_embeddings:  # tied: the logits read embed, as in the JAX init
        tree["head"] = held("head", L._normal(gen, (d, v), 0.02, dt))
    tree["blocks"] = [held(f"blocks/{i}", init_block(gen, cfg, spec))
                      for i, spec in enumerate(layer_specs(cfg))]
    if cfg.frontend == "vision_stub":
        tree["vision_proj"] = held("vision_proj", L._normal(gen, (d, d), 0.02, dt))
    return DecoderLM(cfg, tree)


def init_cache(cfg: ModelConfig, batch: int, seq: int, window: int = 0, device=None):
    """The cache of a global batch of ``batch``: under a mesh, this rank's
    rows of it (``context.local_batch``)."""
    batch = ctx.local_batch(cfg, batch)
    layers = [init_block_cache(cfg, spec, batch, seq, window, device)
              for spec in layer_specs(cfg)]
    return {"layers": layers, "pos": 0}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _embed_inputs(params: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor,
                  vision_embeds: torch.Tensor | None, embed: torch.Tensor) -> torch.Tensor:
    """Token embeddings (B, S, D); under the vision stub, with
    ``vision_embeds`` (B, nv, D) cast to the model's dtype, projected by
    ``vision_proj`` and prepended: (B, nv + S, D). A tensor-parallel
    ``embed`` or ``vision_proj`` holds d columns, all-gathered over
    ``model`` (the backward keeps the rank's columns of the gradient).
    ``embed`` is ``params.embed`` whole over the data axes."""
    x = embed[tokens.to(device=params.device, dtype=torch.int64)]
    if tp.split(params.embed, 1, cfg.d_model):
        x = tp.gather(x)
    if cfg.frontend == "vision_stub" and vision_embeds is not None:
        ve = vision_embeds.to(device=params.device, dtype=x.dtype) @ Z.full(params.vision_proj)
        if tp.split(params.vision_proj, 1, cfg.d_model):
            ve = tp.gather(ve)
        x = torch.cat([ve, x], dim=1)
    return x


def _prefill_positions(cfg: ModelConfig, positions, s: int, device) -> tuple[torch.Tensor, bool]:
    """(the prefill's positions on ``device``, whether attention masks by
    them): ``arange(S)``, or under M-RoPE the batch's (B, S, 3) streams. The
    JAX layers mask by the t stream ``lin_pos = positions[0, :, 0]``; read on
    the host copy, a t stream that is ``arange(S)`` keeps flash_attention's
    index mask (the same mask, today's launches), any other (a real image's
    tokens share one t) makes it mask by the stream (``by_position``). A
    negative t raises ``ValueError``: its query would see no key, where
    JAX's -1e30 fill averages V over the masked keys."""
    if cfg.rope_variant != "mrope":
        if positions is not None:
            raise ValueError(f"{cfg.name}: a {cfg.rope_variant} RoPE prefill takes no positions "
                             f"(it runs at arange(S))")
        return torch.arange(s, dtype=torch.int32, device=device), False
    if positions is None or tuple(positions.shape[1:]) != (s, 3):
        raise ValueError(f"{cfg.name}: M-RoPE takes positions (B, {s}, 3), got "
                         f"{None if positions is None else tuple(positions.shape)}")
    if is_fake(positions):  # a dry run's batch holds no values: arange's, the index mask
        return positions.to(device=device, dtype=torch.int32), False
    if positions.device.type != "cpu":
        raise ValueError("M-RoPE positions must come in the batch as a host tensor: their t "
                         "stream is read there, without a read of the device")
    t = positions[0, :, 0].to(torch.int64)
    if bool((t < 0).any()):
        raise ValueError(f"{cfg.name}: a negative t position (the mask's positions[0, :, 0]) "
                         f"leaves its query no visible key")
    return positions.to(device=device, dtype=torch.int32), not torch.equal(t, torch.arange(s))


def forward(params: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor, *, positions=None,
            vision_embeds: torch.Tensor | None = None, cache=None, window: int = 0,
            mode: str = "prefill", remat: bool = True):
    """tokens (B, S) -> (logits (B, S', V_padded) float32, new_cache, aux),
    S' = S plus the vision tokens prepended under the vision stub.
    mode: prefill (S' tokens at positions 0..S'-1; under M-RoPE
    ``positions`` (B, S', 3) from the batch, a host tensor, attention
    masked by its t stream; given a ``cache``, the Mamba layers continue
    it and the attention layers start afresh, as in JAX) | decode (one
    token at ``cache["pos"]``; under M-RoPE its three streams there) |
    train (the prefill's positions, no cache, new_cache None; under
    autograd, each block checkpointed when ``remat``). prefill and decode
    run under ``torch.no_grad``. A tensor-parallel head (V columns a rank)
    gives the prefill's logits at the last position only, (B, 1, V).
    ``aux`` is the sum of the MoE layers' auxiliary (load-balance) losses,
    0 without MoE layers."""
    if mode == "train":
        return _forward(params, cfg, tokens, positions, vision_embeds, None, window, mode, remat)
    if mode not in ("prefill", "decode"):
        raise ValueError(f"forward mode {mode!r}: one of train, prefill, decode")
    with torch.no_grad():
        return _forward(params, cfg, tokens, positions, vision_embeds, cache, window, mode, False)


def _forward(params, cfg, tokens, positions, vision_embeds, cache, window, mode, remat):
    embed = Z.full(params.embed)  # whole over the data axes once: the lookup and a tied head
    x = _embed_inputs(params, cfg, tokens, vision_embeds, embed)
    s = x.shape[1]
    by_position = False
    if mode == "decode":
        positions = cache["pos"]
    else:
        positions, by_position = _prefill_positions(cfg, positions, s, x.device)
    seq = mode == "train" and ctx.seq_split(s)
    if seq:  # each model rank's S/n tokens of the stream between blocks
        x = tp.sp_split(x)

    new_layers = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (blk, spec) in enumerate(zip(params.blocks, params.specs)):
        c = cache["layers"][i] if cache is not None else None
        if remat:  # jax.checkpoint around the block: recomputed in the backward
            x, nc, aux = checkpoint(apply_block, blk, x, positions, cfg, spec, window=window,
                                    mode=mode, by_position=by_position, seq=seq,
                                    use_reentrant=False, preserve_rng_state=False)
        else:
            x, nc, aux = apply_block(blk, x, positions, cfg, spec, cache=c, window=window,
                                     mode=mode, by_position=by_position, seq=seq)
        new_layers.append(nc)
        if aux is not None:
            aux_total = aux_total + aux

    x = L.rms_norm(x, Z.full(params.final_norm), cfg.norm_eps)
    if seq:  # whole rows for the head and the loss; every rank's use of them alike
        x = tp.sp_gather(x, shares=False)
    logits = _logits(params, cfg, x, embed, mode)
    if mode == "train":
        return logits, None, aux_total
    next_pos = cache["pos"] + 1 if (cache is not None and mode == "decode") else s
    return logits, {"layers": new_layers, "pos": next_pos}, aux_total


def _logits(params: DecoderLM, cfg: ModelConfig, x: torch.Tensor, embed: torch.Tensor,
            mode: str) -> torch.Tensor:
    """float32 logits of the final hidden states ``x``: ``x @ head``, or
    under tied embeddings ``x @ embed.T`` (``embed`` whole over the data
    axes). A tensor-parallel head holds V columns, all-gathered over
    ``model``; a tensor-parallel tied head holds d columns of ``embed``, so
    its product is a row product: the rank's d columns of ``x`` times its
    block's transpose, the float32 partials summed over ``model``
    (``tp.row``), then cast to ``x``'s dtype as the unsplit product is.
    Either gives the prefill's last position only."""
    head = embed.t() if cfg.tie_embeddings else Z.full(params.head)
    split = (tp.split(params.embed, 1, cfg.d_model) if cfg.tie_embeddings
             else tp.split(params.head, 1, cfg.vocab_padded))
    if not split:
        return (x @ head).to(torch.float32)
    if mode == "prefill":  # the prefill step reads the last position only
        x = x[:, -1:]
    if not cfg.tie_embeddings:
        return tp.gather((tp.enter(x) @ head).to(torch.float32))
    _, (cols,) = model_block("embed", (cfg.vocab_padded, cfg.d_model), ctx.get_mesh(), cfg)
    return tp.row(tp.enter(x)[..., cols], head).to(torch.float32)


# ---------------------------------------------------------------------------
# losses & steps
# ---------------------------------------------------------------------------


def nll_terms(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(the masked sum of the negative log-likelihoods of ``labels`` (B, S)
    under the float32 ``logits`` (B, S, V) over the whole (padded)
    vocabulary, the count of labels >= 0), both float32."""
    labels = labels.to(device=logits.device, dtype=torch.int64)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, torch.clamp_min(labels, 0)[..., None])[..., 0]
    m = (labels >= 0).to(torch.float32)
    return torch.sum(nll * m), torch.sum(m)


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` (B, S) under the float32
    ``logits`` (B, S, V) over the whole (padded) vocabulary, labels -1
    ignored (the mean is over the rest, at least 1)."""
    total, count = nll_terms(logits, labels)
    return total / torch.clamp_min(count, 1.0)


def _train_logits(params, cfg, batch, window, remat):
    logits, _, aux = forward(params, cfg, batch["tokens"], positions=batch.get("positions"),
                             vision_embeds=batch.get("vision_embeds"), window=window,
                             mode="train", remat=remat)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:  # vlm: the vision prefix emits logits too
        logits = logits[:, -labels.shape[1]:]
    return logits, labels, aux


def lm_objective(params: DecoderLM, cfg: ModelConfig, batch: dict, *, window: int = 0,
                 remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(what this rank differentiates, the loss the step returns) on the
    global ``batch``. Without a mesh both are ``lm_loss``, one tensor;
    under one, ``shard_objective``'s pair."""
    if ctx.get_mesh() is None:
        loss = lm_loss(params, cfg, batch, window=window, remat=remat)
        return loss, loss
    return shard_objective(cfg, batch, lambda b: _train_logits(params, cfg, b, window, remat))


def shard_objective(cfg: ModelConfig, batch: dict, run) -> tuple[torch.Tensor, torch.Tensor]:
    """(this rank's objective, the loss) of the JAX package's sharded step
    (``jax.jit`` with the batch over the data axes, as ``launch/dryrun.py``
    lowers it) on the global ``batch``, under the open mesh context;
    ``run(rows)`` gives (logits, labels, aux) of a batch of rows.

    The rank runs its rows (``context.data_rows``) and divides their masked
    NLL sum by the count of unmasked labels in the global batch, which
    every rank holds; the sum of these shares over the data ranks is the
    global NLL mean. An expert-parallel MoE returns one aux a data shard
    (each routes its own tokens), and JAX's gradient is that of the mean of
    the shards' auxes, so each rank adds ``0.01 * aux / n_dp``. The loss
    JAX returns (``out_shardings=P()``) is the global NLL mean plus 0.01
    times data shard 0's aux: one all-reduce over the data axes gives it to
    every rank, detached. Where every rank runs the whole batch
    (``data_rows`` None), its share is the whole loss over ``n_dp``, since
    the data ranks' gradients are summed. The ``model`` ranks of a data
    shard compute the same share."""
    mesh = ctx.get_mesh()
    n_dp = ctx.n_data()
    rows = ctx.data_rows(cfg, batch["tokens"].shape[0])
    count = torch.clamp_min(torch.sum((batch["labels"] >= 0).to(torch.float32)), 1.0)
    local = batch if rows is None else {k: v[rows] for k, v in batch.items()}
    logits, labels, aux = run(local)
    total, _ = nll_terms(logits, labels)
    nll = total / count.to(total.device)
    if rows is None:
        objective = (nll + 0.01 * aux) / n_dp
        loss = nll.detach() + 0.01 * aux.detach()
    else:
        objective = nll + 0.01 * aux / n_dp
        first = float(mesh.index(ctx.dp_axes()) == 0)
        terms = mesh.all_reduce(torch.stack([total.detach(), first * aux.detach()]), ctx.dp_axes())
        loss = terms[0] / count.to(total.device) + 0.01 * terms[1]
    return objective, loss


def lm_loss(params: DecoderLM, cfg: ModelConfig, batch: dict, *, window: int = 0,
            remat: bool = True) -> torch.Tensor:
    """Causal LM loss, the JAX package's: batch {"tokens" (B, S), "labels"
    (B, S) with -1 = ignore, and under the vision stub ``vision_embeds`` and
    ``positions``}; the vision prefix's logits are cut off before the NLL;
    plus 0.01 times the MoE layers' aux loss. A float32 scalar on the
    model's device, differentiable in its parameters. Under a mesh, the
    global batch's loss JAX's sharded step returns, on every rank and
    detached (``lm_objective``, whose first value the step
    differentiates)."""
    if ctx.get_mesh() is not None:
        return lm_objective(params, cfg, batch, window=window, remat=remat)[1]
    logits, labels, aux = _train_logits(params, cfg, batch, window, remat)
    return token_nll(logits, labels) + 0.01 * aux


def param_tree(model: nn.Module) -> dict[str, nn.Parameter]:
    """The model's parameters by name: the tree an optimizer's state
    mirrors (``opt.init(param_tree(model))``)."""
    return dict(model.named_parameters())


def stream_len(cfg: ModelConfig, batch: dict) -> int:
    """The positions of the residual stream a step of ``batch`` runs: its
    tokens, and the vision prefix under the vision stub."""
    s = batch["tokens"].shape[1]
    if cfg.frontend == "vision_stub" and batch.get("vision_embeds") is not None:
        s += batch["vision_embeds"].shape[1]
    return s


def seq_norms(model: nn.Module, cfg: ModelConfig, batch: dict) -> tuple[str, ...]:
    """The parameters whose gradients a train step of ``model`` on the
    global ``batch`` sums over ``model`` (``zero.reduce_grads``): every
    norm where the step splits its stream (``context.seq_split``), since
    each ``model`` rank runs them on its own tokens; none elsewhere."""
    if not ctx.seq_split(stream_len(cfg, batch)):
        return ()
    return tuple(n for n, _ in model.named_parameters()
                 if n.rsplit(".", 1)[-1] in ("norm1", "norm2", "final_norm"))


def apply_train_step(model: nn.Module, opt_state, optimizer, loss_of, over_model=()):
    """One optimizer step of ``model`` in place: ``loss_of()`` returns
    (what this rank differentiates, the loss), ``lm_objective``'s or
    ``whisper.whisper_objective``'s pair (one tensor twice without a mesh);
    the gradient of the first with respect to every parameter (a parameter
    it does not reach gets zeros, as JAX's grad gives), ``optimizer.update``
    on the ``param_tree`` and ``p + update`` rounded to p's dtype (the JAX
    ``apply_updates``). Returns (model, opt_state, loss as a device tensor);
    nothing is read back to the host.

    The optimizer runs in place where it offers to (``Optimizer.apply_``:
    the same arithmetic bit for bit, one copy of the moments and the
    state's tensors overwritten). Under a mesh the parameters are this
    rank's blocks and their gradients come summed over the data ranks, and
    those named in ``over_model`` over ``model`` too
    (``zero.reduce_grads``), as a ``SplitTree``."""
    tree = param_tree(model)
    mesh = ctx.get_mesh()
    for p in tree.values():
        p.requires_grad_(True)
    with torch.enable_grad():
        objective, loss = loss_of()
        grads = torch.autograd.grad(objective, list(tree.values()), allow_unused=True)
    grads = {name: torch.zeros_like(p) if g is None else g
             for (name, p), g in zip(tree.items(), grads)}
    params = {name: p.detach() for name, p in tree.items()}
    if mesh is not None:
        grads = Z.reduce_grads(grads, tree, mesh, over_model)
    if optimizer.apply_ is not None:
        return model, optimizer.apply_(grads, opt_state, params), loss.detach()
    updates, opt_state = optimizer.update(grads, opt_state, params)
    del grads
    with torch.no_grad():
        for name, p in tree.items():
            p.copy_((p + updates[name]).to(p.dtype))
    return model, opt_state, loss.detach()


def make_train_step(cfg: ModelConfig, optimizer, window: int = 0, remat: bool = True):
    def train_step(params: DecoderLM, opt_state, batch: dict):
        """One step on the global ``batch`` (``lm_loss``'s; under a mesh
        ``lm_objective``'s): (params updated in place, opt_state, loss)."""
        return apply_train_step(params, opt_state, optimizer,
                                lambda: lm_objective(params, cfg, batch, window=window,
                                                     remat=remat),
                                seq_norms(params, cfg, batch))

    return train_step


def make_prefill_step(cfg: ModelConfig, window: int = 0):
    def prefill_step(params: DecoderLM, batch: dict):
        """batch {"tokens" (B, S)}, plus ``vision_embeds`` and ``positions``
        under the vision stub -> (last-position logits (B, V), cache). Under
        a mesh: the rank's rows run, the logits are gathered."""
        b = batch["tokens"].shape[0]
        rows = ctx.data_rows(cfg, b) or slice(None)
        batch = {k: v[rows] for k, v in batch.items()}
        logits, cache, _ = forward(params, cfg, batch["tokens"], positions=batch.get("positions"),
                                   vision_embeds=batch.get("vision_embeds"), window=window,
                                   mode="prefill")
        # the clone frees the (B, S, V) logits
        return ctx.gather_rows(cfg, logits[:, -1].clone(), b), cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, window: int = 0):
    def decode_step(params: DecoderLM, cache: dict, token: torch.Tensor):
        """token (B, 1) -> (logits (B, V), new_cache); writes the cache in
        place. The position is ``cache["pos"]`` (under M-RoPE all three
        streams, the JAX decode step's (B, 1, 3) positions). Under a mesh:
        the rank's rows of ``token`` run on its cache, the logits are
        gathered."""
        b = token.shape[0]
        logits, new_cache, _ = forward(params, cfg, token[ctx.data_rows(cfg, b) or slice(None)],
                                       cache=cache, window=window, mode="decode")
        return ctx.gather_rows(cfg, logits[:, 0], b), new_cache

    return decode_step
