"""The LM, dense and moe families: pre-RMSNorm GQA decoder with a SwiGLU
or GELU MLP, RoPE and an optional QKV bias; the moe family takes a
capacity-routed MoE FFN with optional shared experts (:mod:`.moe`) in
place of the MLP.

Port of ``repro/models/lm.py``.  The reference's stacked parameter tree
becomes an :class:`LM` module of trainable parameters whose names follow
the reference's dict (``embed``, ``layers.<i>.ln1``,
``layers.<i>.attn.wq``, ``layers.<i>.mlp.w_gate`` or
``layers.<i>.moe.router``, ``final_norm``, ``lm_head``); a Python loop
over the layers replaces ``lax.scan``.  The MoE layers' load-balance and
z-loss terms are summed over the layers and added to the training loss
as the reference adds them (``0.01·load_balance + 0.001·z_loss``).

Remat follows ``cfg.remat_policy`` as the reference's ``jax.checkpoint``
does, through ``torch.utils.checkpoint`` (non-reentrant), and only where a
backward will follow (grad mode on and trainable parameters): ``"full"``
keeps each decoder layer's input and recomputes the layer in the
backward; ``"save_attn"`` keeps the attention block's output as well and
recomputes the attention and MLP blocks each on its own.  The chunked loss
recomputes each chunk's float32 logits in the backward, as the
reference's checkpointed chunk body does, so a step never holds every
chunk's logits at once.  Prefill and decode run without grad and take
none of this.  What the reference does and this module does not:

* ``sharding.constrain`` is a no-op on one device and is not ported
  (ROADMAP A13b, second half);
* the decode caches are updated in place (see ``decode_attention``).

The other families raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.engine import resolve_device
from .attention import Attention, decode_attention, self_attention
from .common import Dtype, dense_init, gelu_mlp, rms_norm, swiglu
from .moe import MoE, moe_ffn

__all__ = ["LM", "forward_logits", "forward_loss", "init_decode_state",
           "decode_step", "check_family", "UNPORTED_FAMILIES"]

LOSS_CHUNK = 512

#: families the port runs
PORTED_FAMILIES = ("dense", "moe")
#: families of the reference not ported yet → the ROADMAP item that ports them
UNPORTED_FAMILIES = {
    "hybrid": "A13d (hybrid family: Mamba branch)",
    "ssm": "A13e (ssm family: xLSTM blocks)",
    "vlm": "A13f (vlm family: cross-attention)",
    "audio": "A13f (audio family: encoder and cross-attention)",
}


def check_family(cfg: ArchConfig) -> None:
    """Raise unless the port runs ``cfg``'s family."""
    if cfg.family not in PORTED_FAMILIES:
        item = UNPORTED_FAMILIES.get(cfg.family, "A13")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP {item})")


class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        d, f = cfg.d_model, cfg.d_ff
        self.gated = cfg.mlp_type == "swiglu"
        if self.gated:
            self.w_gate = nn.Parameter(dense_init((d, f), dtype, **kw))
            self.w_up = nn.Parameter(dense_init((d, f), dtype, **kw))
            self.w_down = nn.Parameter(dense_init((f, d), dtype, **kw))
        else:
            self.w_up = nn.Parameter(dense_init((d, f), dtype, **kw))
            self.b_up = nn.Parameter(torch.zeros(f, dtype=dtype, device=device))
            self.w_down = nn.Parameter(dense_init((f, d), dtype, **kw))
            self.b_down = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))

    def forward(self, x):
        if self.gated:
            return swiglu(x, self.w_gate, self.w_up, self.w_down)
        return gelu_mlp(x, self.w_up, self.b_up, self.w_down, self.b_down)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, *, generator=None, device=None):
        super().__init__()
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype, device=device))
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                              bias=cfg.qkv_bias, dtype=dtype, generator=generator,
                              device=device)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype, device=device))
        if cfg.n_experts:
            self.moe = MoE(cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.n_shared_experts,
                           dtype, generator=generator, device=device)
        else:
            self.mlp = MLP(cfg, dtype, generator=generator, device=device)


class LM(nn.Module):
    """The LM's weights (the reference's ``init_params``),
    drawn from ``generator`` (seeded 0 on ``device`` when not given)
    directly on ``device`` (default: the current card; raises without one)."""

    def __init__(self, cfg: ArchConfig, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        dtype = Dtype(cfg.dtype).param
        kw = dict(generator=generator, device=device)
        with torch.no_grad():
            self.embed = nn.Parameter(dense_init((cfg.vocab, cfg.d_model), dtype, scale=0.02, **kw))
            self.final_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype, device=device))
            if not cfg.tie_embeddings:
                self.lm_head = nn.Parameter(dense_init((cfg.d_model, cfg.vocab), dtype, **kw))
            self.layers = nn.ModuleList(DecoderLayer(cfg, dtype, **kw)
                                        for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


# ----------------------------------------------------------------------
# prefill / eval forward


def _attn_block(cfg: ArchConfig, layer: DecoderLayer, h, use_kernel):
    return self_attention(
        layer.attn, rms_norm(h, layer.ln1), n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.d_head, rope_theta=cfg.rope_theta, causal=True, window=cfg.attn_window,
        use_kernel=use_kernel, impl=cfg.attn_impl,
        probs_dtype=torch.bfloat16 if cfg.attn_probs_dtype == "bfloat16" else None)


def _mlp_block(cfg: ArchConfig, layer: DecoderLayer, h):
    """The layer's MLP or MoE on the normed h → (y, aux terms or None)."""
    x = rms_norm(h, layer.ln2)
    if cfg.n_experts:
        return moe_ffn(layer.moe, x, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                       dispatch_sharding=cfg.moe_dispatch_sharding)
    return layer.mlp(x), None


def _decoder_layer(cfg: ArchConfig, layer: DecoderLayer, h, use_kernel):
    """One decoder layer → (h, its aux terms or None)."""
    h = h + _attn_block(cfg, layer, h, use_kernel)
    y, aux = _mlp_block(cfg, layer, h)
    return h + y, aux


def _zero_aux(cfg: ArchConfig, device):
    if cfg.n_experts:
        return {k: torch.zeros((), dtype=torch.float32, device=device)
                for k in ("load_balance", "z_loss")}
    return None


def _remat(model: LM) -> bool:
    """Whether a backward will follow: grad mode on and trainable weights."""
    return torch.is_grad_enabled() and any(p.requires_grad for p in model.parameters())


def _run_decoder(cfg: ArchConfig, model: LM, h, *, use_kernel=False):
    """The decoder stack → (h, the aux terms summed over the layers, or
    None for a family without them)."""
    remat = _remat(model)
    aux = _zero_aux(cfg, h.device)
    for layer in model.layers:
        if not remat:
            h, a = _decoder_layer(cfg, layer, h, use_kernel)
        elif cfg.remat_policy == "save_attn":
            h = h + checkpoint(_attn_block, cfg, layer, h, use_kernel, use_reentrant=False)
            y, a = checkpoint(_mlp_block, cfg, layer, h, use_reentrant=False)
            h = h + y
        else:
            h, a = checkpoint(_decoder_layer, cfg, layer, h, use_kernel, use_reentrant=False)
        if aux is not None:
            aux = {k: aux[k] + a[k] for k in aux}
    return h, aux


def _chunked_loss(cfg: ArchConfig, model: LM, h, labels):
    """h (B,S,d), labels (B,S) → mean NLL, ``loss_chunk`` positions at a
    time so the full (B,S,V) logits never exist."""
    b, s, _ = h.shape
    chunk = min(cfg.loss_chunk if cfg.loss_chunk > 0 else LOSS_CHUNK, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the loss chunk {chunk}")
    head = model.head()
    remat = _remat(model)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, chunk):
        args = (h[:, i:i + chunk], head, labels[:, i:i + chunk])
        total = total + (checkpoint(_chunk_nll, *args, use_reentrant=False) if remat
                         else _chunk_nll(*args))
    return total / (b * s)


def _chunk_nll(h, head, labels):
    """Summed NLL of one chunk: h (B,c,d), labels (B,c)."""
    logits = (h @ head).float()
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(logits, -1) - gold).sum()


def _embed(model: LM, tokens):
    return F.embedding(tokens.long(), model.embed)


@torch.no_grad()
def forward_logits(cfg: ArchConfig, model: LM, batch, *, use_kernel=False):
    """Full (B,S,V) float32 logits — test/eval only, so without grad
    (training takes :func:`forward_loss`)."""
    h, _ = _run_decoder(cfg, model, _embed(model, batch["tokens"]), use_kernel=use_kernel)
    return (rms_norm(h, model.final_norm) @ model.head()).float()


def forward_loss(cfg: ArchConfig, model: LM, batch, *, use_kernel=False):
    """batch: tokens (B,S), labels (B,S).  Returns (loss, metrics):
    ``nll``, ``loss`` and, for the moe family, ``load_balance`` and
    ``z_loss`` (summed over the layers; ``loss`` adds 0.01 and 0.001 of
    them)."""
    h, aux = _run_decoder(cfg, model, _embed(model, batch["tokens"]), use_kernel=use_kernel)
    loss = _chunked_loss(cfg, model, rms_norm(h, model.final_norm), batch["labels"])
    metrics = dict(nll=loss)
    if aux is not None:
        loss = loss + 0.01 * aux["load_balance"] + 0.001 * aux["z_loss"]
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


# ----------------------------------------------------------------------
# decode (single-token serve step)


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int, *, device=None):
    """Zero caches (L,B,T,H_kv,D) in the param dtype and position 0, on
    ``device`` (default: the current card; raises without one)."""
    check_family(cfg)
    device = resolve_device(device)
    dt = Dtype(cfg.dtype).param
    t = min(cfg.attn_window, seq_len) if cfg.attn_window else seq_len
    shape = (cfg.n_layers, batch, t, cfg.n_kv_heads, cfg.d_head)
    return dict(cache=dict(k=torch.zeros(shape, dtype=dt, device=device),
                           v=torch.zeros(shape, dtype=dt, device=device)),
                pos=torch.zeros((), dtype=torch.int32, device=device))


def decode_step(cfg: ArchConfig, model: LM, state, tokens):
    """One decode step.  tokens (B,) int → (logits (B,V) float32, state).

    The returned state holds the same cache tensors, written in place,
    and the next position."""
    pos = state["pos"]
    cache = state["cache"]
    h = _embed(model, tokens[:, None])
    for i, layer in enumerate(model.layers):
        x = rms_norm(h, layer.ln1)
        out, _, _ = decode_attention(
            layer.attn, x, cache["k"][i], cache["v"][i], pos, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, rope_theta=cfg.rope_theta,
            window=cfg.attn_window)
        h = h + out
        h = h + _mlp_block(cfg, layer, h)[0]      # the MoE's T is the decode batch
    logits = rms_norm(h, model.final_norm) @ model.head()
    return logits[:, 0].float(), dict(cache=cache, pos=pos + 1)
