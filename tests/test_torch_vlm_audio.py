"""The port's vlm and audio families against the JAX package's, on the CPU:
``cross_attention`` (gated and ungated, with GQA, float32 and bf16),
Whisper's encoder (``_run_encoder``), then llama-vision-smoke (one group,
and ``n_layers=4``: two groups) and whisper-smoke whole: weights and an
optimizer state carried both ways, logits and loss with the kernel guard
passed (the reference's Pallas attention in interpret mode), decode
against the reference's decode and against prefill, ``make_serve_step``,
one train step, both remat policies, ``launch.serve``; and what the port
refuses (``ServeEngine`` and ``TrainLoop`` for these families, a decode
step without its ``vision`` or ``memory``, state helpers without a card).

Every cross-attention ``gate`` (zero at init, so that a vlm's cross layers
add nothing) is set to 0.5 in the numpy tree before the weights are
carried, so that the comparisons hold the cross layers too; whisper's
decoder does not read its gates (``gated=False``), on either side.
Inputs are made with numpy from a seed.

Tolerances:

* float32: atol 2e-4, rtol 1e-3 (the reference's own decode-vs-prefill
  tolerance, ``tests/test_archs.py``): both sides sum float32 products in
  different orders;
* ``cross_attention`` in bf16: atol and rtol 5e-2, mean difference below
  1e-2.  Both round the projections, the probabilities and the output to
  bf16 (2^-8 relative) at the same places but sum in other orders, so an
  element may land a bf16 step or two away (outputs reach about 3, where a
  step is 2^-7 ≈ 8e-3); over the output the mean stays within a step;
* one train step's updated parameters at the reference's resume tolerance
  (atol 1e-5, rtol 1e-4), as ``tests/test_torch_moe.py`` holds the MoE's;
  an element whose gradient is below 1e-6 (Adam's step moves steeply with
  it) is held to 2 lr;
* remat against none: the same float32 operations, recomputed: rtol 1e-6.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import get_smoke as r_get_smoke
from repro.models import attention as r_attention
from repro.models import lm as r_lm
from repro.models.steps import make_serve_step as r_make_serve_step
from repro.models.steps import make_train_step as r_make_train_step
from repro.optim import adamw_init as r_adamw_init
from repro.roofline import analysis as r_roofline

from repro_torch import interop
from repro_torch.configs import SHAPES, get_config, get_smoke
from repro_torch.data import synthetic_batch
from repro_torch.models import attention, lm, ssm
from repro_torch.models.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.optim import adamw_init
from repro_torch.roofline import model_flops
from repro_torch.serve import ServeEngine
from repro_torch.train import TrainConfig, TrainLoop

F32_TOL = dict(atol=2e-4, rtol=1e-3)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
STEP_TOL = dict(atol=1e-5, rtol=1e-4)
VLM, AUDIO = "llama-3.2-vision-11b", "whisper-base"
#: (arch, config changes): the vlm smoke config is one group of two layers;
#: n_layers=4 makes two groups, so that a fault in the group index shows
CASES = {"vlm-1group": (VLM, {}), "vlm-2groups": (VLM, dict(n_layers=4)),
         "audio": (AUDIO, {})}
#: overrides that pass the attention kernel's guard (d_head 64; S = 128 below):
#: the vlm with GQA (two heads, one KV head), whisper without (H = H_kv)
GUARD = {VLM: dict(d_model=128, n_heads=2, n_kv_heads=1),
         AUDIO: dict(d_model=128, n_heads=2, n_kv_heads=2)}
GATE = 0.5


def _cfgs(arch, dtype="float32", **kw):
    return (replace(r_get_smoke(arch), dtype=dtype, **kw),
            replace(get_smoke(arch), dtype=dtype, **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _params(rcfg, seed):
    """The reference's seeded parameters as numpy, every gate at GATE."""
    params = _np(r_lm.init_params(rcfg, jax.random.key(seed)))
    for stack in ("xattn", "dec_xattn"):
        if stack in params:
            gate = params[stack]["attn"]["gate"]
            params[stack]["attn"]["gate"] = np.full_like(gate, GATE)
    return params


def _batch(cfg, seed, b, s):
    """Seeded tokens and labels, and ``vision`` or ``frames``, as numpy."""
    batch = synthetic_batch(seed, 0, b, s, cfg.vocab)
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        batch["vision"] = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model)) \
            .astype(np.float32)
    else:
        batch["frames"] = rng.standard_normal((b, cfg.encoder_frames, cfg.d_model)) \
            .astype(np.float32)
    return batch


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    arch, fix = CASES[request.param]
    rcfg, cfg = _cfgs(arch, **fix)
    params = _params(rcfg, 0)
    return rcfg, cfg, params, interop.lm_params_from_numpy(cfg, params, device="cpu")


# ---------------------------------------------------------------- cross-attention


def _cross_params(d, h, hkv, dh, dtype, seed):
    p = r_attention.init_cross_attn(jax.random.key(seed), d, h, hkv, dh, dtype=dtype)
    p["gate"] = jnp.asarray(GATE, dtype)
    mod = attention.CrossAttention(d, h, hkv, dh, dtype=torch.bfloat16
                                   if dtype == jnp.bfloat16 else torch.float32, device="cpu")
    assert {k for k, _ in mod.named_parameters()} == set(p)
    with torch.no_grad():
        for k, v in p.items():
            getattr(mod, k).copy_(torch.from_numpy(np.array(_f32(v))))
    return p, mod


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("h,hkv", [(4, 2), (4, 4)])
def test_cross_attention_matches(gated, h, hkv):
    d, dh, b, s, t = 64, 16, 2, 12, 20
    p, mod = _cross_params(d, h, hkv, dh, jnp.float32, h + hkv)
    rng = np.random.default_rng(h * 10 + hkv)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    feats = rng.standard_normal((b, t, d)).astype(np.float32)
    kw = dict(n_heads=h, n_kv_heads=hkv, d_head=dh, gated=gated)
    want = r_attention.cross_attention(p, jnp.asarray(x), jnp.asarray(feats), **kw)
    got = attention.cross_attention(mod, torch.from_numpy(x), torch.from_numpy(feats), **kw)
    assert got.shape == (b, s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), np.asarray(want), **F32_TOL)
    ungated = attention.cross_attention(mod, torch.from_numpy(x), torch.from_numpy(feats),
                                        **dict(kw, gated=False))
    scale = float(np.tanh(np.float32(GATE))) if gated else 1.0
    torch.testing.assert_close(got, ungated * scale, rtol=1e-6, atol=1e-7)


def test_cross_attention_bf16_matches():
    d, h, hkv, dh = 64, 4, 2, 16
    p, mod = _cross_params(d, h, hkv, dh, jnp.bfloat16, 7)
    rng = np.random.default_rng(7)
    x, feats = (jnp.asarray(rng.standard_normal(s)).astype(jnp.bfloat16)
                for s in ((2, 12, d), (2, 20, d)))
    kw = dict(n_heads=h, n_kv_heads=hkv, d_head=dh)
    want = r_attention.cross_attention(p, x, feats, **kw)
    got = attention.cross_attention(mod, torch.from_numpy(_f32(x)).bfloat16(),
                                    torch.from_numpy(_f32(feats)).bfloat16(), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)
    assert np.abs(_f32(got) - _f32(want)).mean() < 1e-2


def test_cross_attention_gate_is_zero_at_init():
    mod = attention.CrossAttention(64, 4, 2, 16, dtype=torch.bfloat16, device="cpu")
    assert mod.gate.shape == () and mod.gate.dtype == torch.bfloat16 \
        and float(mod.gate.detach()) == 0
    assert not hasattr(mod, "bq")
    x = torch.randn(1, 3, 64, dtype=torch.bfloat16)
    out = attention.cross_attention(mod, x, torch.randn(1, 5, 64, dtype=torch.bfloat16),
                                    n_heads=4, n_kv_heads=2, d_head=16)
    assert not out.any()


# ---------------------------------------------------------------- encoder


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_encoder_matches(dtype):
    rcfg, cfg = _cfgs(AUDIO, dtype)
    params = _params(rcfg, 1)
    model = interop.lm_params_from_numpy(cfg, params, device="cpu")
    frames = _batch(cfg, 1, 2, 4)["frames"]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    rparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), params)
    want = jax.jit(lambda p, f: r_lm._run_encoder(rcfg, p, f))(
        rparams, jnp.asarray(frames).astype(jdt))
    with torch.no_grad():
        got = lm._run_encoder(cfg, model, torch.from_numpy(_f32(jnp.asarray(frames).astype(jdt)))
                              .to(model.embed.dtype))
    assert got.shape == (2, cfg.encoder_frames, cfg.d_model) and got.dtype == model.embed.dtype
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
    else:
        # two layers of bf16 rounding at different places; LayerNorm output O(1)
        np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)
        assert np.abs(_f32(got) - _f32(want)).mean() < 1e-2


# ---------------------------------------------------------------- weights


def test_lm_params_carry_both_ways(pair):
    rcfg, cfg, params, model = pair
    assert sum(p.numel() for p in model.parameters()) == \
        sum(a.size for a in jax.tree.leaves(params))
    if cfg.family == "vlm":
        g = cfg.cross_attn_every
        n_groups = cfg.n_layers // g
        assert params["layers"]["attn"]["wq"].shape[:2] == (n_groups, g)
        assert len(model.layers) == n_groups * g and len(model.xattn) == n_groups
        for i in range(len(model.layers)):
            np.testing.assert_array_equal(_f32(model.layers[i].mlp.w_up),
                                          params["layers"]["mlp"]["w_up"][i // g, i % g])
        for k in range(n_groups):
            np.testing.assert_array_equal(_f32(model.xattn[k].attn.wk),
                                          params["xattn"]["attn"]["wk"][k])
            assert float(model.xattn[k].attn.gate.detach()) == GATE
    else:
        assert len(model.encoder) == cfg.encoder_layers and len(model.dec_xattn) == cfg.n_layers
        np.testing.assert_array_equal(_f32(model.encoder[1].attn.bv),
                                      params["encoder"]["attn"]["bv"][1])
        np.testing.assert_array_equal(_f32(model.dec_xattn[1].attn.wv),
                                      params["dec_xattn"]["attn"]["wv"][1])
        np.testing.assert_array_equal(_f32(model.enc_pos), params["enc_pos"])
        assert model.enc_pos.shape == (cfg.encoder_frames, cfg.d_model)
    back = interop.lm_params_to_numpy(cfg, model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for path, a in jax.tree_util.tree_leaves_with_path(back):
        want = params
        for k in path:
            want = want[k.key]
        assert a.shape == want.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a, want)
    with pytest.raises(KeyError, match="no place"):
        interop.lm_params_from_numpy(cfg, dict(params, extra=np.zeros(3)), device="cpu")


def test_opt_state_carries_both_ways(pair):
    rcfg, cfg, params, model = pair
    rng = np.random.default_rng(5)
    state = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                         _np(r_adamw_init(params)))
    state["count"] = np.asarray(3, np.int32)
    ours = interop.opt_state_from_numpy(cfg, state, model)
    assert set(ours["mu"]) == {n for n, _ in model.named_parameters()}
    back = interop.opt_state_to_numpy(cfg, ours)
    assert jax.tree.structure(back) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        np.testing.assert_array_equal(a, b)


def test_bf16_lm_params_carry_exactly():
    for arch in (VLM, AUDIO):
        rcfg, cfg = _cfgs(arch, "bfloat16")
        params = r_lm.init_params(rcfg, jax.random.key(2))
        model = interop.lm_params_from_numpy(cfg, _np(params), device="cpu")
        assert all(p.dtype == torch.bfloat16 for p in model.parameters())
        for a, b in zip(jax.tree.leaves(interop.lm_params_to_numpy(cfg, model)),
                        jax.tree.leaves(jax.tree.map(lambda v: np.asarray(
                            v.astype(jnp.float32)), params))):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- prefill


def _count_flash(monkeypatch):
    calls = []
    real = attention.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(attention, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("case", list(CASES))
def test_forward_logits_and_loss_match_with_the_kernel(case, monkeypatch):
    arch, fix = CASES[case]
    rcfg, cfg = _cfgs(arch, **fix, **GUARD[arch])
    assert cfg.d_head % 64 == 0
    params = _params(rcfg, 3)
    model = interop.lm_params_from_numpy(cfg, params, device="cpu")
    batch = _batch(cfg, 3, 2, 128)
    want = jax.jit(lambda p, b: r_lm.forward_logits(rcfg, p, b, use_pallas=True))(
        params, _j(batch))
    calls = _count_flash(monkeypatch)
    got = lm.forward_logits(cfg, model, _t(batch), use_kernel=True)
    # the decoder's causal self-attention only: not the cross layers, not the encoder
    assert len(calls) == cfg.n_layers
    assert got.shape == (2, 128, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    plain = lm.forward_logits(cfg, model, _t(batch))
    np.testing.assert_allclose(plain.numpy(), got.numpy(), **F32_TOL)
    _, wm = jax.jit(lambda p, b: r_lm.forward_loss(rcfg, p, b, use_pallas=True))(
        params, _j(batch))
    gm = make_prefill_step(cfg, use_kernel=True)(model, _t(batch))
    assert set(gm) == set(wm) == {"loss", "nll"}
    for key in ("loss", "nll"):
        np.testing.assert_allclose(float(gm[key]), float(wm[key]), **F32_TOL, err_msg=key)
    assert abs(float(gm["nll"]) - np.log(cfg.vocab)) < 1.5


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_logits_move_with_the_cross_inputs(arch):
    # with the gates at 0.5 the vision features (and the frames) reach the logits
    rcfg, cfg = _cfgs(arch)
    model = interop.lm_params_from_numpy(cfg, _params(rcfg, 4), device="cpu")
    batch = _t(_batch(cfg, 4, 2, 8))
    key = "vision" if arch == VLM else "frames"
    a = lm.forward_logits(cfg, model, batch)
    b = lm.forward_logits(cfg, model, dict(batch, **{key: batch[key] * 2 + 1}))
    assert float((a - b).abs().max()) > 1e-2
    if arch == VLM:    # at init the gates are zero: the vision features add nothing
        fresh = lm.LM(cfg, device="cpu")
        torch.testing.assert_close(lm.forward_logits(cfg, fresh, batch),
                                   lm.forward_logits(cfg, fresh, dict(batch, vision=batch[
                                       "vision"] * 2 + 1)), rtol=0, atol=0)


# ---------------------------------------------------------------- decode


def _decode_inputs(rcfg, cfg, params, model, batch):
    """(the reference's, the port's) decode keywords: the vision features,
    or the encoder's output over the frames."""
    if cfg.family == "vlm":
        return dict(vision=jnp.asarray(batch["vision"])), \
            dict(vision=torch.from_numpy(batch["vision"]))
    memory = jax.jit(lambda p, f: r_lm._run_encoder(rcfg, p, f))(params,
                                                                   jnp.asarray(batch["frames"]))
    with torch.no_grad():
        ours = lm._run_encoder(cfg, model, torch.from_numpy(batch["frames"]))
    np.testing.assert_allclose(ours.numpy(), np.asarray(memory), **F32_TOL)
    return dict(memory=memory), dict(memory=ours)


def test_decode_matches_the_reference_and_prefill(pair):
    rcfg, cfg, params, model = pair
    s = 12
    batch = _batch(cfg, 6, 2, s)
    prefill = lm.forward_logits(cfg, model, _t(batch))
    rkw, kw = _decode_inputs(rcfg, cfg, params, model, batch)
    rstep = jax.jit(lambda p, st, t, kw: r_lm.decode_step(rcfg, p, st, t, **kw))
    rstate = r_lm.init_decode_state(rcfg, 2, s)
    with torch.inference_mode():
        state = lm.init_decode_state(cfg, 2, s, device="cpu")
        for t in range(s):
            want, rstate = rstep(params, rstate, jnp.asarray(batch["tokens"][:, t]), rkw)
            got, state = lm.decode_step(cfg, model, state,
                                        torch.from_numpy(batch["tokens"][:, t]), **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL, err_msg=f"{t}")
            np.testing.assert_allclose(got.numpy(), prefill[:, t].numpy(), **F32_TOL,
                                       err_msg=f"{t}")
    assert int(state["pos"]) == int(rstate["pos"]) == s
    for key in ("k", "v"):
        np.testing.assert_allclose(state["cache"][key].numpy(),
                                   np.asarray(rstate["cache"][key]), **F32_TOL)


def test_serve_step_matches_the_reference(pair):
    rcfg, cfg, params, model = pair
    b, steps = 3, 6
    batch = _batch(cfg, 7, b, steps)
    rkw, kw = _decode_inputs(rcfg, cfg, params, model, batch)
    rserve = jax.jit(r_make_serve_step(rcfg))
    serve = make_serve_step(cfg)
    rstate = r_lm.init_decode_state(rcfg, b, 16)
    with torch.inference_mode():
        state = lm.init_decode_state(cfg, b, 16, device="cpu")
    rtok = jnp.zeros((b,), jnp.int32)
    tok = torch.zeros(b, dtype=torch.int32)
    for t in range(steps):
        want, rstate = rserve(params, rstate, dict(tokens=rtok, **rkw))
        got, state = serve(model, state, dict(tokens=tok, **kw))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL, err_msg=f"{t}")
        rtok = jnp.argmax(want, -1).astype(jnp.int32)
        tok = torch.argmax(got, -1).to(torch.int32)
        assert tok.tolist() == np.asarray(rtok).tolist()


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_decode_step_raises_without_its_cross_input(arch):
    _, cfg = _cfgs(arch)
    model = lm.LM(cfg, device="cpu")
    with torch.inference_mode():
        state = lm.init_decode_state(cfg, 1, 4, device="cpu")
        with pytest.raises(ValueError, match="vision" if arch == VLM else "memory"):
            lm.decode_step(cfg, model, state, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="vision" if arch == VLM else "frames"):
        lm.forward_logits(cfg, model, dict(tokens=torch.zeros(1, 4, dtype=torch.int32)))


# ---------------------------------------------------------------- training


def test_train_step_matches_the_reference(pair):
    rcfg, cfg, params, model = pair
    model = interop.lm_params_from_numpy(cfg, params, device="cpu")   # not the shared one
    kw = dict(base_lr=1e-3, total_steps=10, warmup_steps=2)
    batch = _batch(cfg, 8, 4, 16)
    jbatch = _j(batch)
    grads = jax.jit(jax.grad(lambda p, b: r_lm.forward_loss(rcfg, p, b)[0]))(params, jbatch)
    jparams, _, want = jax.jit(r_make_train_step(rcfg, **kw))(
        params, r_adamw_init(params), jbatch, jnp.int32(0))
    _, got = make_train_step(cfg, **kw)(model, adamw_init(model), batch, 0)
    assert set(got) == set(want) == {"loss", "nll", "grad_norm", "lr"}
    for key in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, err_msg=key)
    lr = float(want["lr"])
    flat_want = dict(jax.tree_util.tree_leaves_with_path(_np(jparams)))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(_np(grads)))
    for path, a in jax.tree_util.tree_leaves_with_path(interop.lm_params_to_numpy(cfg, model)):
        w, g = flat_want[path], flat_g[path]
        limit = np.where((np.abs(g) < 1e-6) & (g != 0), 2 * lr,
                         STEP_TOL["atol"] + STEP_TOL["rtol"] * np.abs(w))
        assert not (np.abs(a - w) > limit).any(), (jax.tree_util.keystr(path),
                                                   float(np.abs(a - w).max()))
    if cfg.family == "vlm":
        assert np.abs(flat_g[tuple(jax.tree_util.DictKey(k) for k in
                                   ("xattn", "attn", "gate"))]).min() > 0
    else:
        # whisper's decoder reads no gate: zero gradients, only AdamW's decay
        gate = (jax.tree_util.DictKey("dec_xattn"), jax.tree_util.DictKey("attn"),
                jax.tree_util.DictKey("gate"))
        assert not flat_g[gate].any()
        after = np.array([_f32(blk.attn.gate) for blk in model.dec_xattn])
        np.testing.assert_allclose(after, GATE * (1 - lr * 0.1), rtol=1e-6)


def test_train_step_microbatched_equals_whole(pair):
    _, cfg, params, _ = pair
    batch = _batch(cfg, 9, 4, 16)
    runs = []
    for mb in (0, 2):
        model = interop.lm_params_from_numpy(cfg, params, device="cpu")
        _, m = make_train_step(cfg, microbatch=mb)(model, adamw_init(model), batch, 0)
        runs.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-5)


def _grads(cfg, model, batch):
    loss, _ = lm.forward_loss(cfg, model, batch)
    return torch.autograd.grad(loss, list(model.parameters()), allow_unused=True,
                               materialize_grads=True)


def test_remat_policies_give_equal_gradients(pair, monkeypatch):
    _, cfg, params, model = pair
    batch = _t(_batch(cfg, 10, 2, 32))
    full = _grads(cfg, model, batch)
    save = _grads(replace(cfg, remat_policy="save_attn"), model, batch)
    monkeypatch.setattr(lm, "checkpoint", lambda fn, *a, **kw: fn(*a))   # no remat
    none = _grads(cfg, model, batch)
    names = [n for n, _ in model.named_parameters()]
    cross = "xattn.0.attn.wv" if cfg.family == "vlm" else "dec_xattn.0.attn.wv"
    assert float(none[names.index(cross)].abs().max()) > 0
    if cfg.is_encdec:
        assert float(none[names.index("encoder.0.attn.wq")].abs().max()) > 0
    for a, b, c in zip(full, save, none):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(b, c, rtol=1e-6, atol=1e-9)


def test_param_count_and_model_flops_match_the_reference():
    for arch in (VLM, AUDIO):
        cfg, rcfg = get_config(arch), r_get_config(arch)
        assert cfg.param_count() == rcfg.param_count()
        for shape in SHAPES.values():
            assert model_flops(cfg, shape) == r_roofline.model_flops(rcfg, shape)


# ---------------------------------------------------------------- entry points


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_launch_serve_smoke_on_cpu(arch, capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", arch, "--smoke", "--batch", "2", "--tokens", "3",
                       "--device", "cpu"]) == 0
    assert "2 streams × 3 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_serve_engine_and_train_loop_refuse_the_family(arch, tmp_path):
    _, cfg = _cfgs(arch)
    model = lm.LM(cfg, device="cpu")
    with pytest.raises(ValueError, match="make_serve_step"):
        ServeEngine(cfg, model, device="cpu")
    with pytest.raises(ValueError, match="make_train_step"):
        TrainLoop(cfg, TrainConfig(steps=1, ckpt_dir=str(tmp_path)), device="cpu")


def test_unknown_family_raises():
    _, cfg = _cfgs(VLM)
    with pytest.raises(NotImplementedError, match="no LM family 'speech'"):
        lm.LM(replace(cfg, family="speech"), device="cpu")


def test_state_helpers_raise_without_a_card_and_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda **kw: ssm.mamba_init_state(2, 8, 4, **kw),
                 lambda **kw: ssm.mlstm_init_state(2, 2, 4, **kw),
                 lambda **kw: ssm.slstm_init_state(2, 2, 4, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        state = make(device="cpu")
        tensors = state.values() if isinstance(state, dict) else [state]
        assert all(t.device.type == "cpu" and t.dtype == torch.float32 for t in tensors)
