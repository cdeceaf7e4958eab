"""The port's LM training path against the JAX package's, on the CPU:
schedules, AdamW and momentum SGD, the token pipeline, the attention
backward's plain versions, ``FlashAttentionFn``, ``make_train_step``
(plain, microbatched and through the kernel route), remat, the training
loop's resume and checkpoints carried between the two packages.

Every input is made with numpy from a seed and handed to both packages;
weights go across with ``repro_torch.interop``.  The reference cannot
differentiate its Pallas attention (``jax.grad`` through
``flash_attention(interpret=True)`` raises), so its gradients come from
its plain ``_sdpa`` path, which computes the same function.

Tolerances, each with its reason:

* schedules: rtol 1e-6 (float64 on the host against float32 in jax);
* float32 optimizer updates: rtol 1e-5, atol 1e-8 (the same float32
  formulas, fused in another order); bf16 parameters: within one bf16
  step of their value (2^-7 relative; rounding the same float32 result
  may land on either side);
* attention forward and gradients: rtol 1e-4, atol 1e-5 (float32 sums in
  another order); against float64 autograd, rtol 1e-4, atol 1e-5;
* train steps: loss and grad_norm rtol 1e-4; parameters atol 1e-5, rtol
  1e-4 (the reference's own resume tolerance, ``tests/test_substrates.py``).
  The one exception is an element whose gradient came within 100× Adam's
  eps (0 < |g| < 1e-6) at some step: Adam's step there, mu/(sqrt(nu) + 1e-8),
  moves steeply with g, and the two packages' float32 gradients differ by
  ~4e-8, so such an element is held only to the largest move Adam can make
  (the sum of the learning rates, twice).
"""
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.data import synthetic_batch as r_synthetic_batch
from repro.models import attention as r_attention
from repro.models import lm as r_lm
from repro.models.steps import make_train_step as r_make_train_step
from repro.optim import adamw_init as r_adamw_init
from repro.optim import adamw_update as r_adamw_update
from repro.optim import cosine_schedule as r_cosine
from repro.optim import linear_warmup as r_warmup
from repro.optim import sgdm_init as r_sgdm_init
from repro.optim import sgdm_update as r_sgdm_update
from repro.roofline import analysis as r_roofline
from repro.train import TrainConfig as RTrainConfig
from repro.train import TrainLoop as RTrainLoop

from repro_torch import interop
from repro_torch.configs import SHAPES, get_config, get_smoke
from repro_torch.data import TokenPipeline, synthetic_batch
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import FlashAttentionFn, flash_attention
from repro_torch.models import lm
from repro_torch.models.steps import make_train_step
from repro_torch.optim import (
    adamw_init, adamw_update, cosine_schedule, linear_warmup, sgdm_init, sgdm_update,
)
from repro_torch.roofline import HW, model_flops, parse_shape_bytes, roofline_terms
from repro_torch.train import TrainConfig, TrainLoop

STEP_TOL = dict(atol=1e-5, rtol=1e-4)
ATTN_TOL = dict(atol=1e-5, rtol=1e-4)
# d_head 64 and S = 128 pass the kernel guard; one KV head for two heads is GQA
SMALL = dict(d_model=128, n_heads=2, n_kv_heads=1)


def _cfgs(**kw):
    base = dict(dtype="float32", **kw)
    return replace(r_get_smoke("granite-3-8b"), **base), replace(get_smoke("granite-3-8b"), **base)


# ---------------------------------------------------------------- schedules


@pytest.mark.parametrize("args", [(3e-4, 20, 200), (1e-3, 1, 50), (2e-4, 0, 300),
                                  (5e-4, 100, 100)])
def test_schedules_match(args):
    base_lr, warmup, total = args
    steps = np.arange(301)
    for mine, theirs in ((cosine_schedule(*args), r_cosine(*args)),
                         (linear_warmup(base_lr, warmup), r_warmup(base_lr, warmup))):
        got = np.array([mine(int(s)) for s in steps])
        want = np.array([float(theirs(jnp.int32(s))) for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------- optimizers


def _tree(rng, dtype, grad_scale):
    shapes = {"w": (8, 16), "b": (16,), "emb": (32, 8), "norm": (8,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (grad_scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    jt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jparams = {k: jnp.asarray(v).astype(jt) for k, v in params.items()}
    tparams = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bf16" else torch.float32) for k, v in jparams.items()}
    return jparams, tparams, grads


def _close_params(got, want, dtype):
    for k in want:
        g, w = got[k].float().numpy(), np.asarray(want[k].astype(jnp.float32))
        if dtype == "bf16":
            np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=1e-8, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-8, err_msg=k)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])      # below and above the clip
def test_adamw_update_matches(dtype, grad_scale):
    jparams, tparams, grads = _tree(np.random.default_rng(3), dtype, grad_scale)
    jstate, tstate = r_adamw_init(jparams), adamw_init(tparams)
    assert all(m.dtype == torch.float32 for m in tstate["mu"].values())
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jg = {k: jnp.asarray(v).astype(jparams[k].dtype) for k, v in g.items()}
        tg = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(tparams[k].dtype)
              for k, v in jg.items()}
        jparams, jstate, jnorm = r_adamw_update(jparams, jg, jstate, lr=lr)
        tparams, tstate, tnorm = adamw_update(tparams, tg, tstate, lr=lr)
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
        _close_params(tparams, jparams, dtype)
        for m in ("mu", "nu"):   # atol: float32 rounding of the terms that cancel
            for k in jparams:
                want = np.asarray(jstate[m][k])
                np.testing.assert_allclose(tstate[m][k].numpy(), want, rtol=1e-5,
                                           atol=1e-6 * np.abs(want).max(), err_msg=f"{m} {k}")
        assert int(tstate["count"]) == int(jstate["count"]) == i + 1
        assert tstate["count"].dtype == torch.int32


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sgdm_update_matches(dtype):
    jparams, tparams, grads = _tree(np.random.default_rng(4), dtype, 1.0)
    jstate, tstate = r_sgdm_init(jparams), sgdm_init(tparams)
    for g in grads:
        jg = {k: jnp.asarray(v).astype(jparams[k].dtype) for k, v in g.items()}
        tg = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(tparams[k].dtype)
              for k, v in jg.items()}
        jparams, jstate = r_sgdm_update(jparams, jg, jstate, lr=0.05, weight_decay=0.01)
        tparams, tstate = sgdm_update(tparams, tg, tstate, lr=0.05, weight_decay=0.01)
        _close_params(tparams, jparams, dtype)
        for k in jparams:
            np.testing.assert_allclose(tstate["mom"][k].numpy(), np.asarray(jstate["mom"][k]),
                                       rtol=1e-5, atol=1e-7)
    assert int(tstate["count"]) == int(jstate["count"]) == len(grads)


# ---------------------------------------------------------------- tokens


@pytest.mark.parametrize("args,kw", [((0, 0, 8, 128, 256), {}), ((7, 13, 4, 33, 49155), {}),
                                     ((1, 2, 8, 16, 100), dict(shard=1, num_shards=4))])
def test_synthetic_batch_is_bit_identical(args, kw):
    got, want = synthetic_batch(*args, **kw), r_synthetic_batch(*args, **kw)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    pipe = TokenPipeline(3, 4, 16, 64)
    it = pipe.iterate(5)
    np.testing.assert_array_equal(next(it)["tokens"], pipe(5)["tokens"])


# ---------------------------------------------------------------- attention


ATTN_CASES = [  # (B, H, H_kv, S_q, S_k, D, causal)
    (2, 4, 2, 16, 16, 8, True),
    (1, 4, 1, 12, 20, 16, True),      # suffix-aligned: S_q < S_k
    (2, 2, 2, 16, 16, 8, False),
    (1, 6, 3, 10, 24, 8, False),
]


def _qkv(rng, b, h, h_kv, sq, sk, d):
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, h_kv, sk, d)).astype(np.float32),
            rng.standard_normal((b, h_kv, sk, d)).astype(np.float32),
            rng.standard_normal((b, h, sq, d)).astype(np.float32))


@pytest.mark.parametrize("b,h,h_kv,sq,sk,d,causal", ATTN_CASES)
def test_attention_plain_fwd_bwd_match_jax_vjp_of_sdpa(b, h, h_kv, sq, sk, d, causal):
    q, k, v, g = _qkv(np.random.default_rng(sq * sk + h), b, h, h_kv, sq, sk, d)

    def sdpa(q, k, v):   # the reference's (B,S,H,D) layout, suffix-aligned
        out = r_attention._sdpa(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                                v.transpose(0, 2, 1, 3), causal=causal, window=0,
                                q_pos0=sk - sq if causal else 0)
        return out.transpose(0, 2, 1, 3)

    want, vjp = jax.vjp(sdpa, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq_w, dk_w, dv_w = vjp(jnp.asarray(g))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = ref.attention_fwd_ref(tq, tk, tv, causal=causal)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **ATTN_TOL)
    grads = ref.attention_bwd_ref(tq, tk, tv, out, lse, tg, causal=causal)
    for got, w in zip(grads, (dq_w, dk_w, dv_w)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **ATTN_TOL)


@pytest.mark.parametrize("b,h,h_kv,sq,sk,d,causal",
                         ATTN_CASES + [(1, 4, 2, 20, 12, 8, True)])   # 8 rows see no key
def test_attention_plain_bwd_matches_float64_autograd(b, h, h_kv, sq, sk, d, causal):
    q, k, v, g = (torch.from_numpy(a).double()
                  for a in _qkv(np.random.default_rng(sq + sk), b, h, h_kv, sq, sk, d))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*leaves, causal=causal), leaves, g)
    out, lse = ref.attention_fwd_ref(q.float(), k.float(), v.float(), causal=causal)
    if sq > sk and causal:
        assert bool(torch.isinf(lse[:, :, :sq - sk]).all())
        assert bool((out[:, :, :sq - sk] == 0).all())
    got = ref.attention_bwd_ref(q.float(), k.float(), v.float(), out, lse, g.float(),
                                causal=causal)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.float().numpy(), **ATTN_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fn_gradcheck_float64(causal):
    rng = np.random.default_rng(5)
    q, k, v, _ = (torch.from_numpy(a).double() for a in _qkv(rng, 1, 4, 2, 7, 5, 4))
    leaves = tuple(t.requires_grad_() for t in (q, k, v))
    assert torch.autograd.gradcheck(lambda q, k, v: FlashAttentionFn.apply(q, k, v, causal),
                                    leaves)


def test_flash_attention_goes_through_the_function_only_with_grad():
    q, k, v, g = (torch.from_numpy(a) for a in _qkv(np.random.default_rng(6), 1, 2, 1, 8, 8, 8))
    plain = flash_attention(q, k, v)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_()
    out = flash_attention(qg, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    torch.testing.assert_close(out.detach(), plain, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        assert flash_attention(qg, k, v).grad_fn is None


# ---------------------------------------------------------------- train step


def _carry_params(rcfg, cfg, seed):
    params = jax.tree.map(np.asarray, r_lm.init_params(rcfg, jax.random.key(seed)))
    return params, interop.lm_params_from_numpy(cfg, params, device="cpu")


def _assert_params_close(model, cfg, jparams, tiny=None, lr_sum=0.0):
    """Every parameter within STEP_TOL of the reference's; elements flagged
    in ``tiny`` (a tree of bool masks) within 2 × ``lr_sum``."""
    got = interop.lm_params_to_numpy(cfg, model)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jparams)))
    flat_tiny = dict(jax.tree_util.tree_leaves_with_path(tiny)) if tiny is not None else {}
    assert len(flat_got) == len(flat_want)
    for path, a in flat_got:
        want = np.asarray(flat_want[path], np.float32)
        limit = STEP_TOL["atol"] + STEP_TOL["rtol"] * np.abs(want)
        if path in flat_tiny:
            limit = np.where(flat_tiny[path], 2 * lr_sum, limit)
        bad = np.abs(a - want) > limit
        assert not bad.any(), (jax.tree_util.keystr(path), int(bad.sum()),
                               float(np.abs(a - want).max()))


@pytest.mark.parametrize("case", ["plain", "microbatch", "kernel"])
def test_train_step_matches_the_reference_over_three_steps(case, monkeypatch):
    small = SMALL if case == "kernel" else {}
    rcfg, cfg = _cfgs(**small)
    seq = 128 if case == "kernel" else 32
    micro = 2 if case == "microbatch" else 0
    kw = dict(base_lr=1e-3, total_steps=10, warmup_steps=2, microbatch=micro)
    jparams, model = _carry_params(rcfg, cfg, 0)
    jopt, opt = r_adamw_init(jparams), adamw_init(model)
    rstep = jax.jit(r_make_train_step(rcfg, **kw))
    rgrad = jax.jit(jax.grad(lambda p, b: r_lm.forward_loss(rcfg, p, b)[0]))
    step = make_train_step(cfg, use_kernel=case == "kernel", **kw)
    tiny, lr_sum = None, 0.0
    calls = {"fwd": 0, "bwd": 0}
    for name in ("fwd", "bwd"):
        fn = getattr(ref, f"attention_{name}_ref")

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ref, f"attention_{name}_ref", counted)
    for i in range(3):
        batch = synthetic_batch(0, i, 4, seq, cfg.vocab)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        small = jax.tree.map(lambda g: (np.abs(np.asarray(g)) < 1e-6) & (np.asarray(g) != 0),
                             rgrad(jparams, jbatch))
        tiny = small if tiny is None else jax.tree.map(np.logical_or, tiny, small)
        jparams, jopt, want = rstep(jparams, jopt, jbatch, jnp.int32(i))
        lr_sum += float(want["lr"])
        opt, got = step(model, opt, batch, i)
        assert set(got) == set(want) == {"loss", "nll", "grad_norm", "lr"}
        for key in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4,
                                       err_msg=key)
        np.testing.assert_allclose(got["lr"], float(want["lr"]), rtol=1e-6)
        _assert_params_close(model, cfg, jparams, tiny, lr_sum)
    state = interop.opt_state_to_numpy(cfg, opt)
    assert int(state["count"]) == int(jopt["count"]) == 3
    for m in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(state[m]), jax.tree.leaves(jax.tree.map(np.asarray,
                                                                                jopt[m]))):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-7)
    if case == "kernel":   # remat "full": the forward twice, the backward once, per layer
        assert calls == {"fwd": 2 * cfg.n_layers * 3, "bwd": cfg.n_layers * 3}
    else:
        assert calls == {"fwd": 0, "bwd": 0}


def test_grad_compress_is_not_ported_yet():
    """``grad_compress`` is taken and not read, as in the reference's
    ``make_train_step``: the step equals the one without it.  The int8
    all-reduce itself is ``optim.compressed_psum``
    (``tests/test_torch_sharding.py``)."""
    _, cfg = _cfgs()
    batch = synthetic_batch(0, 0, 4, 32, cfg.vocab)
    out = []
    for flag in (True, False):
        model = interop.lm_params_from_numpy(cfg, _carry_params(*_cfgs(), 0)[0], device="cpu")
        _, m = make_train_step(cfg, grad_compress=flag)(model, adamw_init(model), batch, 0)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    [p.detach().clone() for p in model.parameters()]))
    assert out[0][:2] == out[1][:2]
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.equal(a, b)


def _grads(cfg, model, batch, use_kernel):
    loss, _ = lm.forward_loss(cfg, model, batch, use_kernel=use_kernel)
    return torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_remat_policies_give_equal_gradients(use_kernel, monkeypatch):
    _, cfg = _cfgs(**SMALL)
    _, model = _carry_params(_cfgs(**SMALL)[0], cfg, 1)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(1, 0, 2, 128, cfg.vocab).items()}
    full = _grads(cfg, model, batch, use_kernel)
    save = _grads(replace(cfg, remat_policy="save_attn"), model, batch, use_kernel)
    monkeypatch.setattr(lm, "checkpoint", lambda fn, *a, **kw: fn(*a))   # no remat
    none = _grads(cfg, model, batch, use_kernel)
    for a, b, c in zip(full, save, none):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(b, c, rtol=1e-6, atol=1e-9)


def test_training_reduces_loss():
    _, cfg = _cfgs()
    model = lm.LM(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    opt = adamw_init(model)
    step = make_train_step(cfg, base_lr=3e-3, total_steps=100, warmup_steps=5)
    batch = synthetic_batch(2, 0, 4, 16, cfg.vocab)          # memorize one batch
    losses = []
    for i in range(15):
        opt, m = step(model, opt, batch, i)
        losses.append(float(m["nll"]))
    assert losses[-1] < losses[0] * 0.8, losses


def test_inference_paths_keep_no_graph():
    _, cfg = _cfgs(**SMALL)
    model = lm.LM(cfg, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    tokens = torch.zeros((1, 128), dtype=torch.int64)
    assert lm.forward_logits(cfg, model, dict(tokens=tokens), use_kernel=True).grad_fn is None
    loss, _ = lm.forward_loss(cfg, model, dict(tokens=tokens, labels=tokens), use_kernel=True)
    assert loss.grad_fn is not None


# ---------------------------------------------------------------- interop


def test_params_and_opt_state_carry_both_ways():
    rcfg, cfg = _cfgs()
    jparams, model = _carry_params(rcfg, cfg, 3)
    back = interop.lm_params_to_numpy(cfg, model)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    jopt = jax.tree.map(np.asarray, r_adamw_init(jparams))
    jopt["mu"] = jax.tree.map(lambda a: a + 1.5, jopt["mu"])
    jopt["count"] = np.int32(4)
    opt = interop.opt_state_from_numpy(cfg, jopt, model)
    assert set(opt["mu"]) == {n for n, _ in model.named_parameters()}
    assert int(opt["count"]) == 4 and opt["count"].dtype == torch.int32
    again = interop.opt_state_to_numpy(cfg, opt)
    assert jax.tree.structure(again) == jax.tree.structure(jopt)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(jopt)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- loop


def _tc(cls, tmp, name, **kw):
    base = dict(steps=6, batch=4, seq=16, ckpt_dir=str(tmp / name), ckpt_every=2,
                base_lr=1e-3, warmup_steps=2, log_every=1)
    base.update(kw)
    return cls(**base)


def test_train_loop_resume_equals_uninterrupted(tmp_path):
    _, cfg = _cfgs()
    full = TrainLoop(cfg, _tc(TrainConfig, tmp_path, "a"), device="cpu").run()
    TrainLoop(cfg, _tc(TrainConfig, tmp_path, "b", steps=3), device="cpu").run()
    resumed = TrainLoop(cfg, _tc(TrainConfig, tmp_path, "b"), device="cpu").run()
    assert [m["step"] for m in resumed["history"]] == [3, 4, 5]
    assert len(full["history"]) == 6 and full["history"][0]["tokens_per_s"] > 0
    for a, b in zip(full["model"].parameters(), resumed["model"].parameters()):
        torch.testing.assert_close(a, b, **STEP_TOL)
    assert sorted(os.listdir(tmp_path / "b"))[-1] == "step_00000005.npz"


def _final_params(out, cfg):
    if "model" in out:
        return interop.lm_params_to_numpy(cfg, out["model"])
    return jax.tree.map(lambda a: np.asarray(a, np.float32), out["params"])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_train_checkpoints_resume_across_packages(writer, tmp_path):
    """A TrainLoop checkpoint written by one package resumes in the other's
    TrainLoop, which ends where the writer's own uninterrupted run ends."""
    rcfg, cfg = _cfgs()
    if writer == "port":
        def write(tc):
            return TrainLoop(cfg, tc, device="cpu").run()
        wcls, rcls = TrainConfig, RTrainConfig

        def resume(tc):
            return RTrainLoop(rcfg, tc).run()
    else:
        def write(tc):
            return RTrainLoop(rcfg, tc).run()
        wcls, rcls = RTrainConfig, TrainConfig

        def resume(tc):
            return TrainLoop(cfg, tc, device="cpu").run()
    full = write(_tc(wcls, tmp_path, "full"))
    write(_tc(wcls, tmp_path, "cut", steps=3))
    with np.load(tmp_path / "cut" / "step_00000002.npz") as z:
        keys = set(z.files)
    with np.load(tmp_path / "full" / "step_00000002.npz") as z:
        assert keys == set(z.files)
    assert "params|layers|attn|wq" in keys and "opt|count" in keys
    resumed = resume(_tc(rcls, tmp_path, "cut"))
    assert [m["step"] for m in resumed["history"]] == [3, 4, 5]
    got, want = _final_params(resumed, cfg), _final_params(full, cfg)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, **STEP_TOL)


def test_port_checkpoint_keys_equal_the_reference(tmp_path):
    rcfg, cfg = _cfgs()
    TrainLoop(cfg, _tc(TrainConfig, tmp_path, "p", steps=1), device="cpu").run()
    RTrainLoop(rcfg, _tc(RTrainConfig, tmp_path, "r", steps=1)).run()
    with np.load(tmp_path / "p" / "step_00000000.npz") as p, \
            np.load(tmp_path / "r" / "step_00000000.npz") as r:
        assert set(p.files) == set(r.files)
        for key in r.files:
            assert p[key].shape == r[key].shape and p[key].dtype == r[key].dtype, key


def test_launch_train_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    assert train.main(["--arch", "granite-3-8b", "--smoke", "--steps", "3", "--batch", "2",
                       "--seq", "16", "--ckpt-dir", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "done: granite-3-8b-smoke" in out and "on cpu" in out
    assert (tmp_path / "step_00000002.npz").exists()


def test_train_loop_without_device_raises_on_a_cardless_host(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainLoop(cfg, _tc(TrainConfig, tmp_path, "x"))


# ---------------------------------------------------------------- roofline


def test_roofline_matches_the_reference_with_h100_constants():
    for arch in ("granite-3-8b", "qwen2.5-32b"):
        for shape in SHAPES.values():
            from repro.configs import get_config as r_get_config
            assert model_flops(get_config(arch), shape) == \
                r_roofline.model_flops(r_get_config(arch), shape)
    for s in ("bf16[16,2048,512]", "(f32[4,4], bf16[2])", "pred[128]", "f32[]"):
        assert parse_shape_bytes(s) == r_roofline.parse_shape_bytes(s)
    hw = HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)
    cost = {"flops": 989e12, "bytes accessed": 3.35e12 / 2}
    out = roofline_terms(cost, {"total": 0.0}, chips=1)
    want = r_roofline.roofline_terms(cost, {"total": 0.0}, chips=1,
                                     hw=r_roofline.HW(989e12, 3.35e12, 450e9))
    assert out == want and out["dominant"] == "compute" and out["t_compute"] == 1.0
