"""The LM: pre-RMSNorm GQA decoders with a SwiGLU or GELU MLP, RoPE and an
optional QKV bias (dense), a capacity-routed MoE FFN with optional shared
experts in place of the MLP (moe, :mod:`.moe`), a Mamba branch beside
sliding-window attention (hybrid), and xLSTM blocks (ssm, :mod:`.ssm`).

Port of ``repro/models/lm.py``.  The reference's stacked parameter tree
becomes an :class:`LM` module of trainable parameters whose names follow
the reference's dict (``embed``, ``layers.<i>.ln1``,
``layers.<i>.attn.wq``, ``layers.<i>.mlp.w_gate``, ``layers.<i>.moe.router``,
``layers.<i>.mamba.a_log`` or ``layers.<i>.mlstm.wq``, ``final_norm``,
``lm_head``); a Python loop over the layers replaces ``lax.scan``.  The
MoE layers' load-balance and z-loss terms are summed over the layers and
added to the training loss as the reference adds them (``0.01·load_balance
+ 0.001·z_loss``).

A hybrid layer (Hymba) adds ``0.5 · (attention + Mamba)`` of the same
normed input, then its MLP; ``cfg.mamba_impl`` picks the scan or the
associative scan.  An ssm layer holds ``ln1``, an mLSTM and an sLSTM and
nothing else; layer i runs the sLSTM when ``i % k == k − 1`` (k =
``cfg.slstm_every``) and the mLSTM otherwise (``cfg.mlstm_impl``: the scan
or the chunkwise form), a Python branch per layer in place of
``lax.cond``.  The branch a layer does not run takes no part in the loss:
its gradients are zeros (``make_train_step``), as under ``lax.cond``.

Remat follows ``cfg.remat_policy`` as the reference's ``jax.checkpoint``
does, through ``torch.utils.checkpoint`` (non-reentrant), and only where a
backward will follow (grad mode on and trainable parameters): ``"full"``
keeps each decoder layer's input and recomputes the layer in the
backward; ``"save_attn"`` keeps the attention's output as well and
recomputes the attention, the Mamba branch and the MLP block each on its
own (the ssm family has no attention, so it takes ``"full"``, as the
reference's policy saves nothing there).  The chunked loss recomputes
each chunk's float32 logits in the backward, as the reference's
checkpointed chunk body does, so a step never holds every chunk's logits
at once.  Prefill and decode run without grad and take none of this.
What the reference does and this module does not:

* ``sharding.constrain`` is a no-op on one device and is not ported
  (ROADMAP A13b, second half);
* the decode caches and recurrent states are updated in place (see
  ``decode_attention``).

The vlm and audio families raise ``NotImplementedError`` naming their
ROADMAP item.
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
from .ssm import (MLSTM, SLSTM, Mamba, mamba_seq, mamba_seq_assoc, mamba_step,
                  mlstm_init_state, mlstm_seq, mlstm_seq_chunked, mlstm_step, slstm_init_state,
                  slstm_seq, slstm_step)

__all__ = ["LM", "forward_logits", "forward_loss", "init_decode_state",
           "decode_step", "check_family", "UNPORTED_FAMILIES"]

LOSS_CHUNK = 512

#: families the port runs
PORTED_FAMILIES = ("dense", "moe", "hybrid", "ssm")
#: families of the reference not ported yet → the ROADMAP item that ports them
UNPORTED_FAMILIES = {
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
        kw = dict(generator=generator, device=device)
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype, device=device))
        if cfg.family == "ssm":
            self.mlstm = MLSTM(cfg.d_model, cfg.n_heads, dtype, **kw)
            self.slstm = SLSTM(cfg.d_model, cfg.n_heads, dtype, **kw)
            return
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                              bias=cfg.qkv_bias, dtype=dtype, **kw)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype, device=device))
        if cfg.family == "hybrid":
            self.mamba = Mamba(cfg.d_model, cfg.ssm_state, cfg.ssm_conv, dtype, **kw)
        if cfg.n_experts:
            self.moe = MoE(cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.n_shared_experts,
                           dtype, **kw)
        else:
            self.mlp = MLP(cfg, dtype, **kw)


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


def _mamba_block(cfg: ArchConfig, layer: DecoderLayer, h):
    """The hybrid layer's Mamba branch on the same normed input as its attention."""
    mamba = mamba_seq_assoc if cfg.mamba_impl == "assoc" else mamba_seq
    return mamba(layer.mamba, rms_norm(h, layer.ln1), d_state=cfg.ssm_state)


def _mlp_block(cfg: ArchConfig, layer: DecoderLayer, h):
    """The layer's MLP or MoE on the normed h → (y, aux terms or None)."""
    x = rms_norm(h, layer.ln2)
    if cfg.n_experts:
        return moe_ffn(layer.moe, x, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                       dispatch_sharding=cfg.moe_dispatch_sharding)
    return layer.mlp(x), None


def _is_slstm(cfg: ArchConfig, i: int) -> bool:
    """Whether ssm layer ``i`` runs its sLSTM (every ``slstm_every``-th)."""
    k = max(cfg.slstm_every, 1)
    return cfg.slstm_every > 0 and i % k == k - 1


def _ssm_layer(cfg: ArchConfig, layer: DecoderLayer, h, slstm: bool):
    """One xLSTM block: h + the sLSTM or the mLSTM of the normed h."""
    x = rms_norm(h, layer.ln1)
    if slstm:
        return h + slstm_seq(layer.slstm, x, n_heads=cfg.n_heads)
    if cfg.mlstm_impl == "chunked":
        return h + mlstm_seq_chunked(layer.mlstm, x, n_heads=cfg.n_heads,
                                     chunk=cfg.mlstm_chunk)
    return h + mlstm_seq(layer.mlstm, x, n_heads=cfg.n_heads)


def _decoder_layer(cfg: ArchConfig, layer: DecoderLayer, h, use_kernel):
    """One decoder layer → (h, its aux terms or None)."""
    out = _attn_block(cfg, layer, h, use_kernel)
    if cfg.family == "hybrid":
        out = (out + _mamba_block(cfg, layer, h)) * 0.5    # Hymba mean-fuses the branches
    h = h + out
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
    for i, layer in enumerate(model.layers):
        if cfg.family == "ssm":
            args = (cfg, layer, h, _is_slstm(cfg, i))
            h = checkpoint(_ssm_layer, *args, use_reentrant=False) if remat else _ssm_layer(*args)
            continue
        if not remat:
            h, a = _decoder_layer(cfg, layer, h, use_kernel)
        elif cfg.remat_policy == "save_attn":
            out = checkpoint(_attn_block, cfg, layer, h, use_kernel, use_reentrant=False)
            if cfg.family == "hybrid":
                out = (out + checkpoint(_mamba_block, cfg, layer, h, use_reentrant=False)) * 0.5
            h = h + out
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
    """Zero decode state at position 0 on ``device`` (default: the current
    card; raises without one): attention caches (L,B,T,H_kv,D) in the
    param dtype, T = min(window, seq_len) for a sliding window (a ring);
    for hybrid also ``mamba_h`` (L,B,d,N) float32 and ``mamba_conv``
    (L,B,K−1,d) in the param dtype; for ssm the mLSTM and the sLSTM states
    of every layer, float32, ``m`` at −1e30."""
    check_family(cfg)
    device = resolve_device(device)
    dt = Dtype(cfg.dtype).param
    lb = (cfg.n_layers, batch)
    if cfg.family == "ssm":
        dh = cfg.d_model // cfg.n_heads
        states = (mlstm_init_state(batch, cfg.n_heads, dh, device=device),
                  slstm_init_state(batch, cfg.n_heads, dh, device=device))
        cache = {name: {k: v.expand(*lb, *v.shape[1:]).contiguous() for k, v in st.items()}
                 for name, st in zip(("mlstm", "slstm"), states)}
        return dict(cache=cache, pos=torch.zeros((), dtype=torch.int32, device=device))
    t = min(cfg.attn_window, seq_len) if cfg.attn_window else seq_len
    shape = (*lb, t, cfg.n_kv_heads, cfg.d_head)
    cache = dict(k=torch.zeros(shape, dtype=dt, device=device),
                 v=torch.zeros(shape, dtype=dt, device=device))
    if cfg.family == "hybrid":
        cache["mamba_h"] = torch.zeros((*lb, cfg.d_model, cfg.ssm_state), dtype=torch.float32,
                                       device=device)
        cache["mamba_conv"] = torch.zeros((*lb, cfg.ssm_conv - 1, cfg.d_model), dtype=dt,
                                          device=device)
    return dict(cache=cache, pos=torch.zeros((), dtype=torch.int32, device=device))


def _ssm_decode(cfg: ArchConfig, layer: DecoderLayer, h, cache, i: int):
    """One xLSTM block's decode step: only the branch the layer runs reads
    and updates its state (written in place); the other is left as it is."""
    name = "slstm" if _is_slstm(cfg, i) else "mlstm"
    step = slstm_step if name == "slstm" else mlstm_step
    st = {k: v[i] for k, v in cache[name].items()}
    out, new = step(getattr(layer, name), rms_norm(h, layer.ln1), st, n_heads=cfg.n_heads)
    for k, v in st.items():
        v.copy_(new[k])
    return h + out


def decode_step(cfg: ArchConfig, model: LM, state, tokens):
    """One decode step.  tokens (B,) int → (logits (B,V) float32, state).

    The returned state holds the same cache and state tensors, written in
    place, and the next position."""
    pos = state["pos"]
    cache = state["cache"]
    h = _embed(model, tokens[:, None])
    for i, layer in enumerate(model.layers):
        if cfg.family == "ssm":
            h = _ssm_decode(cfg, layer, h, cache, i)
            continue
        x = rms_norm(h, layer.ln1)
        out, _, _ = decode_attention(
            layer.attn, x, cache["k"][i], cache["v"][i], pos, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, rope_theta=cfg.rope_theta,
            window=cfg.attn_window)
        if cfg.family == "hybrid":
            m_out, mh, conv = mamba_step(layer.mamba, x, cache["mamba_h"][i],
                                         cache["mamba_conv"][i], d_state=cfg.ssm_state)
            cache["mamba_h"][i].copy_(mh)
            cache["mamba_conv"][i].copy_(conv)
            out = (out + m_out) * 0.5
        h = h + out
        h = h + _mlp_block(cfg, layer, h)[0]      # the MoE's T is the decode batch
    logits = rms_norm(h, model.final_norm) @ model.head()
    return logits[:, 0].float(), dict(cache=cache, pos=pos + 1)
