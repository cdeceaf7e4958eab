"""The LM: pre-RMSNorm GQA decoders with a SwiGLU or GELU MLP, RoPE and an
optional QKV bias (dense), a capacity-routed MoE FFN with optional shared
experts in place of the MLP (moe, :mod:`.moe`), a Mamba branch beside
sliding-window attention (hybrid), xLSTM blocks (ssm, :mod:`.ssm`), a
dense decoder with gated cross-attention to vision features (vlm), and
Whisper's encoder-decoder (audio).

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

The vlm family runs its ``n_layers // g · g`` decoder layers (g =
``cfg.cross_attn_every``) in groups of g: group k first adds the gated
cross-attention of ``xattn.<k>`` (``ln``, ``attn``) to the batch's
``vision`` features, then runs ``layers.<k·g>`` … ``layers.<k·g+g−1>``
(the reference's two-level scan, ``layers`` stacked ``(n_groups, g, …)``
there).  The audio family (Whisper) runs :func:`_run_encoder` over the
batch's ``frames`` (LayerNorm, bidirectional attention without RoPE, a
QKV bias, learned positions ``enc_pos``), then a decoder whose layer i is
the dense layer followed by the ungated cross-attention of
``dec_xattn.<i>`` to the encoder's output (its ``gate`` exists, unused, as
in the reference).  Decode takes ``vision`` or the encoder's ``memory``
beside the tokens and re-projects their K/V every step, as the reference
does.

Remat follows ``cfg.remat_policy`` as the reference's ``jax.checkpoint``
does, through ``torch.utils.checkpoint`` (non-reentrant), and only where a
backward will follow (grad mode on and trainable parameters): ``"full"``
keeps each decoder layer's input and recomputes the layer in the
backward (the vlm a whole group, the audio decoder a layer with its
cross block, the encoder each layer under any policy, as the reference's
``jax.checkpoint(body)``); ``"save_attn"`` keeps the attention's output
as well and recomputes the attention, the Mamba branch, the cross block
and the MLP block each on its own (the ssm family has no attention, so
it takes ``"full"``, as the reference's policy saves nothing there).  The
chunked loss recomputes each chunk's float32 logits in the backward, as
the reference's checkpointed chunk body does, so a step never holds every
chunk's logits at once.  Prefill and decode run without grad and take
none of this.

On a mesh with a ``model`` dim (the dense family) the embedding is a
vocab-parallel gather where the spec splits ``embed`` over ``model``
(DTensor's masked lookup, then a sum over the ranks), and the loss takes
each chunk's logits split over the vocab (``lm_head`` is ``("fsdp",
"tp")``): the log-sum-exp and the gold logit are summed over the ranks,
so the full logits of a chunk never exist on one rank.  The reference's
gather, ``jnp.take`` of a sharded ``embed``, is not copied: it raises
under a mesh on jax 0.9.0 (ROADMAP C).

What the reference does and this module does not:

* the activations carry no sharding annotation: under a mesh
  (``models.steps.shard_model``) the weights are DTensors, each block
  enters and leaves tensor parallelism itself (``common.tp_in``/
  ``tp_out``, the attention core on local heads) and FSDP gathers a
  decoder layer's weights when the layer is called, so the reference's
  ``sharding.constrain`` calls have nothing to do here;
* the decode caches and recurrent states are updated in place (see
  ``decode_attention``).
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.engine import resolve_device
from .attention import Attention, CrossAttention, cross_attention, decode_attention, \
    self_attention
from .common import Dtype, dense_init, gelu_mlp, layer_norm, replicated, rms_norm, swiglu, \
    tp_in, tp_out
from .moe import MoE, moe_ffn
from .ssm import (M_INIT, MLSTM, SLSTM, Mamba, mamba_seq, mamba_seq_assoc, mamba_step,
                  mlstm_seq, mlstm_seq_chunked, mlstm_step, slstm_seq, slstm_step)

__all__ = ["LM", "forward_logits", "forward_loss", "init_decode_state", "decode_state_shapes",
           "decode_step", "check_family", "PORTED_FAMILIES"]

LOSS_CHUNK = 512

#: families the port runs: every family of the registry
PORTED_FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")


def check_family(cfg: ArchConfig) -> None:
    """Raise unless ``cfg``'s family is one the LM knows."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: no LM family {cfg.family!r} (known: {', '.join(PORTED_FAMILIES)})")


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

    def forward(self, cfg: ArchConfig, h, use_kernel=False, remat=False, slstm=False,
                dp=None):
        """This layer on h → (h, its aux terms or None); ``slstm`` picks an
        ssm layer's branch; ``dp`` is the mesh's data ranks
        (``common.DataRanks``) where the model is sharded, for the MoE,
        which routes over them.  With ``remat``, under ``cfg.remat_policy``:
        ``"full"`` recomputes the whole layer in the backward,
        ``"save_attn"`` each block on its own, keeping the attention's
        output.  Called through the module so that FSDP, where the model
        is sharded, gathers the layer's weights first (and again before
        its recompute in the backward)."""
        if cfg.family == "ssm":
            args = (cfg, self, h, slstm)
            return (checkpoint(_ssm_layer, *args, use_reentrant=False) if remat
                    else _ssm_layer(*args)), None
        if not remat:
            return _decoder_layer(cfg, self, h, use_kernel, dp)
        if cfg.remat_policy != "save_attn":
            return checkpoint(_decoder_layer, cfg, self, h, use_kernel, dp,
                              use_reentrant=False)
        out = checkpoint(_attn_block, cfg, self, h, use_kernel, use_reentrant=False)
        if cfg.family == "hybrid":
            out = (out + checkpoint(_mamba_block, cfg, self, h, use_reentrant=False)) * 0.5
        h = h + out
        y, a = checkpoint(_mlp_block, cfg, self, h, dp, use_reentrant=False)
        return h + y, a


class CrossBlock(nn.Module):
    """A cross-attention block: its pre-norm ``ln`` and ``attn``."""

    def __init__(self, cfg: ArchConfig, dtype, *, generator=None, device=None):
        super().__init__()
        self.ln = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype, device=device))
        self.attn = CrossAttention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                                   dtype=dtype, generator=generator, device=device)


class EncoderLayer(nn.Module):
    """A Whisper encoder layer: LayerNorms with biases, attention with the
    config's QKV bias, the MLP."""

    def __init__(self, cfg: ArchConfig, dtype, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        d = cfg.d_model
        self.ln1 = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.ln1_b = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))
        self.attn = Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, bias=cfg.qkv_bias,
                              dtype=dtype, **kw)
        self.ln2 = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.ln2_b = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))
        self.mlp = MLP(cfg, dtype, **kw)


def n_groups(cfg: ArchConfig) -> int:
    """The vlm family's groups of ``cross_attn_every`` decoder layers."""
    return cfg.n_layers // cfg.cross_attn_every


class LM(nn.Module):
    """The LM's weights (the reference's ``init_params``),
    drawn from ``generator`` (seeded 0 on ``device`` when not given)
    directly on ``device`` (default: the current card; raises without one).
    On ``device="meta"`` the parameters have shapes and no storage (the
    dry run's model)."""

    def __init__(self, cfg: ArchConfig, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        if str(device) == "meta":
            device, generator = torch.device("meta"), None
        else:
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
            depth = n_groups(cfg) * cfg.cross_attn_every if cfg.family == "vlm" else cfg.n_layers
            self.layers = nn.ModuleList(DecoderLayer(cfg, dtype, **kw) for _ in range(depth))
            if cfg.family == "vlm":
                self.xattn = nn.ModuleList(CrossBlock(cfg, dtype, **kw)
                                           for _ in range(n_groups(cfg)))
            if cfg.is_encdec:
                d = cfg.d_model
                self.encoder = nn.ModuleList(EncoderLayer(cfg, dtype, **kw)
                                             for _ in range(cfg.encoder_layers))
                self.enc_norm = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
                self.enc_norm_b = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))
                self.enc_pos = nn.Parameter(dense_init((cfg.encoder_frames, d), dtype,
                                                       scale=0.02, **kw))
                self.dec_xattn = nn.ModuleList(CrossBlock(cfg, dtype, **kw)
                                               for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, batch, cfg: ArchConfig | None = None, use_kernel=False, dp=None):
        """:func:`forward_loss` of ``batch`` under ``cfg`` (default: the
        model's): the training step's entry, through the module so that
        FSDP gathers the root's weights."""
        return forward_loss(cfg or self.cfg, self, batch, use_kernel=use_kernel,
                            dp=dp)

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


def _mlp_block(cfg: ArchConfig, layer: DecoderLayer, h, dp=None):
    """The layer's MLP or MoE on the normed h → (y, aux terms or None).
    ``dp`` (the mesh's data ranks) reaches ``moe_ffn``; on a sharded model
    the MoE finds its ``model`` ranks in its expert stacks' placements."""
    x = rms_norm(h, layer.ln2)
    if cfg.n_experts:
        return moe_ffn(layer.moe, x, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                       dispatch_sharding=cfg.moe_dispatch_sharding, dp=dp)
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


def _decoder_layer(cfg: ArchConfig, layer: DecoderLayer, h, use_kernel, dp=None):
    """One decoder layer → (h, its aux terms or None)."""
    out = _attn_block(cfg, layer, h, use_kernel)
    if cfg.family == "hybrid":
        out = (out + _mamba_block(cfg, layer, h)) * 0.5    # Hymba mean-fuses the branches
    h = h + out
    y, aux = _mlp_block(cfg, layer, h, dp)
    return h + y, aux


def _zero_aux(cfg: ArchConfig, device):
    if cfg.n_experts:
        return {k: torch.zeros((), dtype=torch.float32, device=device)
                for k in ("load_balance", "z_loss")}
    return None


def _remat(model: LM) -> bool:
    """Whether a backward will follow: grad mode on and trainable weights."""
    return torch.is_grad_enabled() and any(p.requires_grad for p in model.parameters())


def _cross_block(cfg: ArchConfig, block: CrossBlock, h, feats, gated: bool):
    """The cross-attention of the normed h to ``feats`` (vision or memory)."""
    return cross_attention(block.attn, rms_norm(h, block.ln), feats, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, gated=gated)


def _cross(cfg: ArchConfig, block: CrossBlock, h, feats, gated: bool, remat: bool):
    """h plus its cross block, the block recomputed in the backward under remat."""
    if remat:
        return h + checkpoint(_cross_block, cfg, block, h, feats, gated, use_reentrant=False)
    return h + _cross_block(cfg, block, h, feats, gated)


def _vlm_group(cfg: ArchConfig, model: LM, k: int, h, vision, use_kernel, remat=False):
    """Group k of the vlm: its cross block, then its g decoder layers."""
    h = _cross(cfg, model.xattn[k], h, vision, True, remat)
    g = cfg.cross_attn_every
    for layer in model.layers[k * g:(k + 1) * g]:
        h, _ = layer(cfg, h, use_kernel, remat)
    return h


def _audio_layer(cfg: ArchConfig, model: LM, i: int, h, memory, use_kernel, remat=False):
    """Decoder layer i of the audio family, then its ungated cross block."""
    h, _ = model.layers[i](cfg, h, use_kernel, remat)
    return _cross(cfg, model.dec_xattn[i], h, memory, False, remat)


def _run_decoder(cfg: ArchConfig, model: LM, h, *, vision=None, memory=None,
                 use_kernel=False, dp=None):
    """The decoder stack → (h, the aux terms summed over the layers, or
    None for a family without them)."""
    remat = _remat(model)
    if cfg.family == "vlm" or cfg.is_encdec:
        # "full" checkpoints a vlm group or an audio layer with its cross
        # block whole (the reference's _remat(group_body) / _remat(dec_body));
        # "save_attn" checkpoints each block inside them
        whole = remat and cfg.remat_policy != "save_attn"
        inner = remat and not whole
        if cfg.family == "vlm":
            body, feats, count = _vlm_group, vision, n_groups(cfg)
        else:
            body, feats, count = _audio_layer, memory, cfg.n_layers
        for i in range(count):
            if whole:
                h = checkpoint(body, cfg, model, i, h, feats, use_kernel, use_reentrant=False)
            else:
                h = body(cfg, model, i, h, feats, use_kernel, inner)
        return h, None
    aux = _zero_aux(cfg, h.device)
    for i, layer in enumerate(model.layers):
        if cfg.family == "ssm":
            h, _ = layer(cfg, h, remat=remat, slstm=_is_slstm(cfg, i))
            continue
        h, a = layer(cfg, h, use_kernel, remat, dp=dp)
        if aux is not None:
            aux = {k: aux[k] + a[k] for k in aux}
    return h, aux


def _encoder_layer(cfg: ArchConfig, layer: EncoderLayer, h):
    x = layer_norm(h, layer.ln1, layer.ln1_b)
    h = h + self_attention(layer.attn, x, causal=False, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, rope_theta=0.0,
                           impl=cfg.attn_impl)
    return h + layer.mlp(layer_norm(h, layer.ln2, layer.ln2_b))


def _run_encoder(cfg: ArchConfig, model: LM, frames):
    """Whisper's encoder over (stub) frame embeddings (B,F,d) → its output
    (B,F,d): learned positions, LayerNorm layers of bidirectional attention
    (no RoPE, no kernel: plain, as the reference's) and the MLP, each
    layer recomputed in the backward where one follows."""
    h = frames + model.enc_pos[None, :frames.shape[1]]
    remat = _remat(model)
    for layer in model.encoder:
        h = (checkpoint(_encoder_layer, cfg, layer, h, use_reentrant=False) if remat
             else _encoder_layer(cfg, layer, h))
    return layer_norm(h, model.enc_norm, model.enc_norm_b)


def _chunked_loss(cfg: ArchConfig, model: LM, h, labels):
    """h (B,S,d), labels (B,S) → mean NLL, ``loss_chunk`` positions at a
    time so the full (B,S,V) logits never exist."""
    b, s, _ = h.shape
    chunk = min(cfg.loss_chunk if cfg.loss_chunk > 0 else LOSS_CHUNK, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the loss chunk {chunk}")
    head = model.head()
    nll = _chunk_nll
    if isinstance(head, DTensor):
        # logits split over the vocab where the spec splits lm_head over model
        nll = _chunk_nll_vocab_parallel if head.placements[0] == Shard(1) else nll
        head = head if nll is _chunk_nll_vocab_parallel else replicated(head)
    remat = _remat(model)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, chunk):
        args = (h[:, i:i + chunk], head, labels[:, i:i + chunk])
        total = total + (checkpoint(nll, *args, use_reentrant=False) if remat else nll(*args))
    return total / (b * s)


def _chunk_nll(h, head, labels):
    """Summed NLL of one chunk: h (B,c,d), labels (B,c)."""
    logits = (h @ head).float()
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(logits, -1) - gold).sum()


def _chunk_nll_vocab_parallel(h, head: DTensor, labels):
    """:func:`_chunk_nll` with ``head`` (d, V) split over the mesh on V:
    each rank's logits cover its slice of the vocab; the running max, the
    sum of exponentials and the gold logit are reduced over the ranks."""
    mesh = head.device_mesh
    logits = (tp_in(h, head) @ head).to_local().float()          # (B, c, V / tp)
    v_local = logits.shape[-1]
    lo = mesh.get_local_rank() * v_local
    m = logits.detach().amax(-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group())
    sumexp = torch.exp(logits - m[..., None]).sum(-1)
    local = labels.long() - lo
    inside = (local >= 0) & (local < v_local)
    gold = logits.gather(-1, local.clamp(0, v_local - 1)[..., None])[..., 0]
    gold = torch.where(inside, gold, 0.0)
    sumexp, gold = (tp_out(DTensor.from_local(t, mesh, [Partial()], run_check=False))
                    for t in (sumexp, gold))
    return (torch.log(sumexp) + m - gold).sum()


def _embed(model: LM, tokens):
    """The embedding lookup; vocab-parallel where ``embed`` is a DTensor
    split over its rows (a masked lookup on each rank, summed)."""
    if isinstance(model.embed, DTensor):
        ids = DTensor.from_local(tokens.long(), model.embed.device_mesh, [Replicate()],
                                 run_check=False)
        return tp_out(F.embedding(ids, model.embed))
    return F.embedding(tokens.long(), model.embed)


def _features(cfg: ArchConfig, model: LM, batch) -> dict:
    """The decoder's cross-attention inputs of a batch: ``vision`` (vlm),
    or the encoder's output over ``frames`` as ``memory`` (audio)."""
    if cfg.family == "vlm":
        return dict(vision=_required(batch.get("vision"), "vision", cfg))
    if cfg.is_encdec:
        return dict(memory=_run_encoder(cfg, model, _required(batch.get("frames"), "frames",
                                                              cfg)))
    return {}


def _required(x, name: str, cfg: ArchConfig):
    if x is None:
        raise ValueError(f"{cfg.name}: the {cfg.family} family needs {name!r}")
    return x


@torch.no_grad()
def forward_logits(cfg: ArchConfig, model: LM, batch, *, use_kernel=False):
    """Full (B,S,V) float32 logits — test/eval only, so without grad
    (training takes :func:`forward_loss`).  ``batch`` holds ``tokens``,
    and ``vision`` (B,T,d) for the vlm family or ``frames`` (B,F,d) for
    the audio family."""
    h, _ = _run_decoder(cfg, model, _embed(model, batch["tokens"]), use_kernel=use_kernel,
                        **_features(cfg, model, batch))
    return (rms_norm(h, model.final_norm) @ model.head()).float()


def forward_loss(cfg: ArchConfig, model: LM, batch, *, use_kernel=False, dp=None):
    """batch: tokens (B,S), labels (B,S), and ``vision`` (vlm) or
    ``frames`` (audio).  Returns (loss, metrics): ``nll``, ``loss`` and,
    for the moe family, ``load_balance`` and ``z_loss`` (summed over the
    layers; ``loss`` adds 0.01 and 0.001 of them).  ``dp``: the mesh's
    data ranks (``common.DataRanks``), over which ``batch`` may be this
    rank's slice (the MoE routes over them as its dispatch mode says)."""
    h, aux = _run_decoder(cfg, model, _embed(model, batch["tokens"]), use_kernel=use_kernel,
                          dp=dp, **_features(cfg, model, batch))
    loss = _chunked_loss(cfg, model, rms_norm(h, model.final_norm), batch["labels"])
    metrics = dict(nll=loss)
    if aux is not None:
        loss = loss + 0.01 * aux["load_balance"] + 0.001 * aux["z_loss"]
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


# ----------------------------------------------------------------------
# decode (single-token serve step)


def _state_leaves(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """The decode state's tree: each leaf as (shape, dtype, fill)."""
    dt = Dtype(cfg.dtype).param
    lb = (cfg.n_layers, batch)
    f32 = torch.float32
    if cfg.family == "ssm":
        h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
        return dict(mlstm=dict(c=((*lb, h, dh, dh), f32, 0.0), n=((*lb, h, dh), f32, 0.0),
                               m=((*lb, h), f32, M_INIT)),
                    slstm=dict(c=((*lb, h, dh), f32, 0.0), n=((*lb, h, dh), f32, 0.0),
                               m=((*lb, h), f32, M_INIT), h=((*lb, h, dh), f32, 0.0)))
    t = min(cfg.attn_window, seq_len) if cfg.attn_window else seq_len
    shape = (*lb, t, cfg.n_kv_heads, cfg.d_head)
    cache = dict(k=(shape, dt, 0.0), v=(shape, dt, 0.0))
    if cfg.family == "hybrid":
        cache["mamba_h"] = ((*lb, cfg.d_model, cfg.ssm_state), f32, 0.0)
        cache["mamba_conv"] = ((*lb, cfg.ssm_conv - 1, cfg.d_model), dt, 0.0)
    return cache


def _map_leaves(fn, tree, prefix=""):
    """``tree`` with each leaf replaced by ``fn(its path "a/b", leaf)``."""
    return {k: (_map_leaves(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
                else fn(f"{prefix}{k}", v)) for k, v in tree.items()}


def decode_state_shapes(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """The shapes of :func:`init_decode_state`'s tree (``cache`` and a 0-d
    ``pos``), without making it: what ``sharding.decode_state_specs``
    places."""
    return dict(cache=_map_leaves(lambda _, leaf: leaf[0], _state_leaves(cfg, batch, seq_len)),
                pos=())


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int, *, device=None, mesh=None):
    """Zero decode state at position 0 on ``device`` (default: the current
    card; raises without one): attention caches (L,B,T,H_kv,D) in the
    param dtype, T = min(window, seq_len) for a sliding window (a ring);
    for hybrid also ``mamba_h`` (L,B,d,N) float32 and ``mamba_conv``
    (L,B,K−1,d) in the param dtype; for ssm the mLSTM and the sLSTM states
    of every layer, float32, ``m`` at −1e30.

    With ``mesh`` (a ``("data", "model")`` DeviceMesh) every cache and
    state is a DTensor placed as ``sharding.decode_state_specs`` says (the
    reference's ``_decode_state_shardings``), each rank allocating its own
    shard only; ``pos`` stays a plain tensor.  A sliding-window ring whose
    positions the placement would split over ranks raises
    ``NotImplementedError``."""
    from .sharding import MeshCtx, decode_state_specs, local_zeros, to_placements

    check_family(cfg)
    device = resolve_device(device)
    leaves = _state_leaves(cfg, batch, seq_len)
    pos = torch.zeros((), dtype=torch.int32, device=device)
    if mesh is None:
        cache = _map_leaves(lambda _, leaf: torch.full(leaf[0], leaf[2], dtype=leaf[1],
                                                       device=device), leaves)
        return dict(cache=cache, pos=pos)
    specs = decode_state_specs(MeshCtx(mesh), decode_state_shapes(cfg, batch, seq_len))["cache"]

    def one(name, leaf):
        spec = specs
        for part in name.split("/"):
            spec = spec[part]
        if cfg.attn_window and name in ("k", "v") and spec[2] is not None:
            raise NotImplementedError(
                f"{cfg.name}: its sliding-window ring cache would be split over ranks on its "
                f"positions ({spec}); not ported (ROADMAP A2)")
        return local_zeros(leaf[0], leaf[1], mesh, to_placements(spec, mesh), device=device,
                           fill=leaf[2])

    return dict(cache=_map_leaves(one, leaves), pos=pos)


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


def _decode_layer(cfg: ArchConfig, layer: DecoderLayer, h, cache, i: int, pos,
                  seq_split=None, dp=None):
    """Attention decoder layer ``i``'s decode step; its caches (and Mamba
    state) are written in place."""
    x = rms_norm(h, layer.ln1)
    out, _, _ = decode_attention(
        layer.attn, x, cache["k"][i], cache["v"][i], pos, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, rope_theta=cfg.rope_theta,
        window=cfg.attn_window, seq_split=seq_split)
    if cfg.family == "hybrid":
        m_out, mh, conv = mamba_step(layer.mamba, x, cache["mamba_h"][i],
                                     cache["mamba_conv"][i], d_state=cfg.ssm_state)
        cache["mamba_h"][i].copy_(mh)
        cache["mamba_conv"][i].copy_(conv)
        out = (out + m_out) * 0.5
    h = h + out
    # the MoE routes the decode batch (this rank's rows under "manual"), capacity from it
    return h + _mlp_block(cfg, layer, h, dp)[0]


@contextmanager
def _gathered(module: nn.Module):
    """``module``'s own parameters whole inside the block where FSDP2
    shards them (its ``unshard``/``reshard``), as its forward hooks would
    gather them: decode calls the layers' parts directly."""
    from torch.distributed.fsdp import FSDPModule

    if not isinstance(module, FSDPModule):
        yield
        return
    module.unshard()
    try:
        yield
    finally:
        module.reshard()


def _seq_split(cache: DTensor):
    """(offset, groups) of a KV cache DTensor (L,B,T,H,D) whose positions
    are split over ranks: the global position of this rank's first slot and
    the groups of the mesh dims that split them; None where none does."""
    from .sharding import local_extent

    mesh = cache.device_mesh
    dims = [i for i, pl in enumerate(cache.placements) if pl == Shard(2) and mesh.size(i) > 1]
    if not dims:
        return None
    offset = local_extent(cache.shape, mesh, cache.placements)[1][2]
    return offset, [mesh.get_group(i) for i in dims]


def _local_rows(cache, rows: int, dp):
    """The cache's local tensors for this rank's ``rows`` tokens, and the
    leaves that hold every row of a batch split over ``dp.group`` (the
    rules put ``model`` on the batch dim of an (L, B, H) state, so over
    the data ranks it is whole): of those, a view of this rank's rows,
    and (whole, first row) to share the rows again after the step."""
    shared = []

    def one(name, leaf):
        t = leaf.to_local() if isinstance(leaf, DTensor) else leaf
        if t.shape[1] == rows:
            return t
        if name in ("k", "v") or dp is None or not dp.split:
            raise NotImplementedError(
                "decode of a KV cache whose batch is not split as the tokens are (the batch "
                "divides the data ranks but not the pod and data ranks) is not ported "
                "(ROADMAP A2)")
        lo = dist.get_rank(dp.group) * rows
        shared.append((t, lo))
        return t[:, lo:lo + rows]

    return _map_leaves(one, cache), shared


def _share_rows(shared, rows: int, dp) -> None:
    """Each rank's updated rows of the leaves :func:`_local_rows` returned
    whole, gathered back into every rank's copy."""
    for t, lo in shared:
        parts = [torch.empty_like(t[:, :rows]) for _ in range(dist.get_world_size(dp.group))]
        dist.all_gather(parts, t[:, lo:lo + rows].contiguous(), group=dp.group)
        t.copy_(torch.cat(parts, 1))


def decode_step(cfg: ArchConfig, model: LM, state, tokens, *, memory=None, vision=None,
                dp=None):
    """One decode step.  tokens (B,) int → (logits (B,V) float32, state).
    The vlm family needs ``vision`` (B,T,d), the audio family the
    encoder's output as ``memory`` (B,F,d) (:func:`_run_encoder`); their
    K/V are projected anew each step, as the reference's are.

    The returned state holds the same cache and state tensors, written in
    place, and the next position.

    On a mesh (``models.steps.make_serve_step(mesh=...)``) ``state`` is
    ``init_decode_state(..., mesh=)``'s, ``tokens`` this rank's rows of
    the batch (all of them where the batch is not split), ``dp`` the
    mesh's data ranks (``common.DataRanks``: the MoE routes over them, and
    the ssm family's states hold every row of a batch split over them),
    and the model is sharded by ``shard_model``: each layer's
    weights are gathered by FSDP for its step, the attention runs on this
    rank's cache shard (``attention.decode_attention``) and the logits,
    gathered over ``model`` where the head is split over the vocab, are
    this rank's rows."""
    if cfg.family == "vlm":
        _required(vision, "vision", cfg)
    if cfg.is_encdec:
        _required(memory, "memory", cfg)
    pos = state["pos"]
    split = _seq_split(state["cache"]["k"]) if isinstance(state["cache"].get("k"), DTensor) \
        else None
    cache, shared = _local_rows(state["cache"], tokens.shape[0], dp)
    g = cfg.cross_attn_every
    with _gathered(model):
        h = _embed(model, tokens[:, None])
        for i, layer in enumerate(model.layers):
            if cfg.family == "vlm" and i % g == 0:
                h = h + _cross_block(cfg, model.xattn[i // g], h, vision, True)
            with _gathered(layer):
                if cfg.family == "ssm":
                    h = _ssm_decode(cfg, layer, h, cache, i)
                    continue
                h = _decode_layer(cfg, layer, h, cache, i, pos, split, dp)
            if cfg.is_encdec:
                h = h + _cross_block(cfg, model.dec_xattn[i], h, memory, False)
        head = model.head()
        h = rms_norm(h, model.final_norm)
        logits = tp_out(tp_in(h, head) @ head)
    _share_rows(shared, tokens.shape[0], dp)
    return logits[:, 0].float(), dict(cache=state["cache"], pos=pos + 1)
