"""The port's LM inference path against the JAX package's, on the CPU:
the plain ``flash_attention`` against the Pallas kernel in interpret
mode, the common blocks, self-attention with the kernel, the prefill
forward (logits and loss), cached decode and the serving engine, all on
inputs made with numpy and weights carried by ``lm_params_from_numpy``.

Tolerances: float32 results agree to atol 2e-4, rtol 1e-3 (the
reference's own decode-vs-prefill tolerance, ``tests/test_archs.py``):
both sides sum float32 products in different orders.  bfloat16 results
are compared in float32 at the tolerance stated beside each test.
"""
import os
import pathlib
import subprocess
import sys
import types
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.kernels import ops as r_ops
from repro.kernels.attn_tile import flash_attention as p_flash
from repro.models import attention as r_attention
from repro.models import common as r_common
from repro.models import lm as r_lm
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine

from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention, common, lm
from repro_torch.models.steps import make_prefill_step, make_serve_step
from repro_torch.serve import Request, ServeEngine

ROOT = pathlib.Path(__file__).resolve().parent.parent
F32_TOL = dict(atol=2e-4, rtol=1e-3)
# d_head 64 and S = 128 pass the kernel guard; one KV head for two heads is GQA
SMALL = dict(d_model=128, n_heads=2, n_kv_heads=1)


def _cfgs(dtype="float32"):
    return (replace(r_get_smoke("granite-3-8b"), dtype=dtype, **SMALL),
            replace(get_smoke("granite-3-8b"), dtype=dtype, **SMALL))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    """A jax array or torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _both(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor (bf16 values
    convert exactly through float32)."""
    j = jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    return j, torch.from_numpy(_f32(j)).to(torch.bfloat16 if dtype == "bf16" else torch.float32)


# ---------------------------------------------------------------- kernel


ATTN_CASES = [
    # the shapes of tests/test_kernels.py::test_flash_attention
    (1, 2, 128, 128, 64, True),
    (2, 1, 128, 256, 64, True),       # suffix-aligned causal (decode-like)
    (1, 1, 256, 256, 128, False),
    (1, 1, 256, 128, 64, False),
    (1, 2, 256, 128, 64, True),       # S_q > S_k: the first 128 rows see no key
]


@pytest.mark.parametrize("b,h,sq,sk,d,causal", ATTN_CASES)
def test_flash_attention_plain_vs_pallas(b, h, sq, sk, d, causal):
    rng = np.random.default_rng(sq * 7 + sk)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))
    want = np.asarray(p_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal)
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_flash_attention_plain_empty_rows_are_zero():
    # S_q > S_k causal: row i sees keys j <= i - 128, so rows < 128 see none;
    # the kernel (and now the plain version) write 0 where -inf gave NaN
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 2, 256, 64), (1, 2, 128, 64), (1, 2, 128, 64)))
    want = np.asarray(p_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                              interpret=True))
    got = ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            causal=True).numpy()
    assert (want[:, :, :128] == 0).all() and (got[:, :, :128] == 0).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_flash_attention_plain_bf16_vs_pallas():
    rng = np.random.default_rng(11)
    jq, tq = _both(rng.standard_normal((1, 2, 128, 64)), "bf16")
    jk, tk = _both(rng.standard_normal((1, 2, 128, 64)), "bf16")
    jv, tv = _both(rng.standard_normal((1, 2, 128, 64)), "bf16")
    want = p_flash(jq, jk, jv, causal=True, interpret=True)
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    # both compute in float32 and round the output to bf16 (2^-8 relative):
    # a rounding-boundary case may differ by one bf16 step
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_gqa_equals_repeated_heads(causal):
    # head h reads KV head h // group, as jnp.repeat on the head axis does
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 4, 128, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 128, 64)).astype(np.float32) for _ in range(2))
    kr, vr = np.repeat(k, 2, axis=1), np.repeat(v, 2, axis=1)
    want = np.asarray(p_flash(jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr), causal=causal,
                              interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    full = flash_attention(torch.from_numpy(q), torch.from_numpy(kr), torch.from_numpy(vr),
                           causal=causal)
    assert torch.equal(got, full)


# ---------------------------------------------------------------- common


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_matches(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _both(rng.standard_normal((2, 5, 64)) * 3, dtype)
    jw, tw = _both(rng.standard_normal(64), dtype)
    # bf16: one rounding of the f32 result to bf16 on each side
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "f32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_f32(common.rms_norm(tx, tw)), _f32(r_common.rms_norm(jx, jw)),
                               **tol)


def test_layer_norm_matches():
    rng = np.random.default_rng(2)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((3, 32), (32,), (32,)))
    np.testing.assert_allclose(
        common.layer_norm(*map(torch.from_numpy, (x, w, b))).numpy(),
        np.asarray(r_common.layer_norm(*map(jnp.asarray, (x, w, b)))), rtol=1e-5, atol=1e-6)


def test_rope_and_apply_rope_match():
    pos = np.array([0, 1, 7, 300, 4095], np.int32)
    jc, js = r_common.rope(jnp.asarray(pos), 128, 1e7)
    tc, ts = common.rope(torch.from_numpy(pos), 128, 1e7)
    assert tc.dtype == torch.float32
    # the same float32 angles; cos/sin of either library within 2 ulp
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    x = np.random.default_rng(3).standard_normal((2, 5, 3, 128)).astype(np.float32)
    got = common.apply_rope(torch.from_numpy(x), tc, ts).numpy()
    np.testing.assert_allclose(got, np.asarray(r_common.apply_rope(jnp.asarray(x), jc, js)),
                               rtol=1e-5, atol=1e-5)


def test_swiglu_and_gelu_mlp_match():
    rng = np.random.default_rng(4)
    x, wg, wu, wd = (rng.standard_normal(s).astype(np.float32) * 0.2
                     for s in ((2, 3, 32), (32, 48), (32, 48), (48, 32)))
    bu, bd = rng.standard_normal(48).astype(np.float32), rng.standard_normal(32).astype(np.float32)
    t = lambda *a: map(torch.from_numpy, a)  # noqa: E731
    j = lambda *a: map(jnp.asarray, a)  # noqa: E731
    np.testing.assert_allclose(common.swiglu(*t(x, wg, wu, wd)).numpy(),
                               np.asarray(r_common.swiglu(*j(x, wg, wu, wd))), **F32_TOL)
    np.testing.assert_allclose(common.gelu_mlp(*t(x, wu, bu, wd, bd)).numpy(),
                               np.asarray(r_common.gelu_mlp(*j(x, wu, bu, wd, bd))), **F32_TOL)


# ---------------------------------------------------------------- attention


def _attn_params(rcfg, seed):
    p = _np(r_attention.init_attn(jax.random.key(seed), rcfg.d_model, rcfg.n_heads,
                                  rcfg.n_kv_heads, rcfg.d_head, bias=True, dtype=jnp.float32))
    rng = np.random.default_rng(seed)       # non-zero biases
    p = {k: (v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)) if k[0] == "b" else v
         for k, v in p.items()}
    return p, types.SimpleNamespace(**{k: torch.from_numpy(v) for k, v in p.items()})


def _akw(cfg):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
                rope_theta=cfg.rope_theta)


@pytest.mark.parametrize("s,window,impl", [(128, 0, "full"), (256, 0, "full"),
                                           (96, 0, "full"), (128, 8, "full"),
                                           (1024, 0, "chunked")])
def test_self_attention_with_kernel_matches(s, window, impl):
    rcfg, cfg = _cfgs()
    jp, tp = _attn_params(rcfg, s)
    x = np.random.default_rng(s).standard_normal((2, s, rcfg.d_model)).astype(np.float32)
    want = r_attention.self_attention(jp, jnp.asarray(x), window=window, use_pallas=True,
                                      impl=impl, **_akw(rcfg))
    got = attention.self_attention(tp, torch.from_numpy(x), window=window, use_kernel=True,
                                   impl=impl, **_akw(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("s", [96, 128, 256])
@pytest.mark.parametrize("window", [0, 8])
def test_kernel_guard_takes_the_reference_path(monkeypatch, s, window):
    rcfg, cfg = _cfgs()
    jp, tp = _attn_params(rcfg, 0)
    calls = {"jax": 0, "torch": 0}

    def count(side, fn):
        def wrapped(*a, **kw):
            calls[side] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(r_ops, "flash_attention", count("jax", r_ops.flash_attention))
    monkeypatch.setattr(attention, "flash_attention", count("torch", attention.flash_attention))
    x = np.zeros((1, s, rcfg.d_model), np.float32)
    r_attention.self_attention(jp, jnp.asarray(x), window=window, use_pallas=True, **_akw(rcfg))
    attention.self_attention(tp, torch.from_numpy(x), window=window, use_kernel=True,
                             **_akw(cfg))
    assert calls["torch"] == calls["jax"] == int(s % 128 == 0 and not window)


# ---------------------------------------------------------------- LM


@pytest.fixture(scope="module")
def lm_pair():
    rcfg, cfg = _cfgs()
    params = _np(r_lm.init_params(rcfg, jax.random.key(0)))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 128)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    return (rcfg, cfg, params, interop.lm_params_from_numpy(cfg, params, device="cpu"),
            tokens, labels)


def test_lm_params_from_numpy_carries_every_weight(lm_pair):
    rcfg, cfg, params, model, _, _ = lm_pair
    assert sum(p.numel() for p in model.parameters()) == \
        sum(a.size for a in jax.tree.leaves(params))
    np.testing.assert_array_equal(model.layers[1].attn.wk.detach().numpy(),
                                  params["layers"]["attn"]["wk"][1])
    np.testing.assert_array_equal(model.lm_head.detach().numpy(), params["lm_head"])
    with pytest.raises(KeyError, match="no place"):
        interop.lm_params_from_numpy(cfg, dict(params, extra=np.zeros(3)), device="cpu")


def test_forward_logits_matches(lm_pair):
    rcfg, cfg, params, model, tokens, _ = lm_pair
    want = jax.jit(lambda p, t: r_lm.forward_logits(rcfg, p, dict(tokens=t), use_pallas=True))(
        params, tokens)
    got = lm.forward_logits(cfg, model, dict(tokens=torch.from_numpy(tokens)), use_kernel=True)
    assert got.shape == (2, 128, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    plain = lm.forward_logits(cfg, model, dict(tokens=torch.from_numpy(tokens)))
    np.testing.assert_allclose(plain.numpy(), got.numpy(), **F32_TOL)


def test_forward_loss_matches(lm_pair):
    rcfg, cfg, params, model, tokens, labels = lm_pair
    want, _ = jax.jit(lambda p, t, y: r_lm.forward_loss(
        rcfg, p, dict(tokens=t, labels=y), use_pallas=True))(params, tokens, labels)
    got = make_prefill_step(cfg, use_kernel=True)(
        model, dict(tokens=torch.from_numpy(tokens), labels=torch.from_numpy(labels)))
    assert set(got) == {"loss", "nll"}
    np.testing.assert_allclose(float(got["loss"]), float(want), **F32_TOL)
    # a random model predicts no better than chance: about ln V
    assert abs(float(got["loss"]) - np.log(cfg.vocab)) < 1.5


def test_decode_step_matches(lm_pair):
    rcfg, cfg, params, model, tokens, _ = lm_pair
    rstep = jax.jit(lambda p, s, t: r_lm.decode_step(rcfg, p, s, t))
    rstate = r_lm.init_decode_state(rcfg, 2, 16)
    step = make_serve_step(cfg)
    with torch.inference_mode():
        state = lm.init_decode_state(cfg, 2, 16, device="cpu")
    prefill = lm.forward_logits(cfg, model, dict(tokens=torch.from_numpy(tokens)),
                                use_kernel=True)
    for t in range(12):
        want, rstate = rstep(params, rstate, jnp.asarray(tokens[:, t]))
        got, state = step(model, state, dict(tokens=torch.from_numpy(tokens[:, t])))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        # teacher-forced decode reproduces the prefill logits
        np.testing.assert_allclose(got.numpy(), prefill[:, t].numpy(), **F32_TOL)
    assert int(state["pos"]) == int(rstate["pos"]) == 12


def _requests(mk):
    return [mk(uid=0, prompt=[5, 9, 2], max_new_tokens=6),
            mk(uid=1, prompt=[7, 11, 13, 1, 4], max_new_tokens=4),
            mk(uid=2, prompt=[3], max_new_tokens=20),             # truncated by the cache
            mk(uid=3, prompt=[8, 8], max_new_tokens=5, eos_id=None)]


def test_serve_engine_token_ids_equal_the_reference(lm_pair):
    rcfg, cfg, params, model, _, _ = lm_pair
    reng = RServeEngine(rcfg, params, batch_slots=3, cache_len=16)
    eng = ServeEngine(cfg, model, batch_slots=3, cache_len=16, device="cpu")
    for r, t in zip(_requests(RRequest), _requests(Request)):
        reng.submit(r)
        eng.submit(t)
    want = {r.uid: (r.output, r.truncated) for r in reng.run_until_drained()}
    got = {r.uid: (r.output, r.truncated) for r in eng.run_until_drained()}
    assert got == want
    assert eng.steps_executed == reng.steps_executed
    assert got[2][1] and not got[0][1]


def test_serve_engine_batch_equals_solo(lm_pair):
    _, cfg, _, model, _, _ = lm_pair
    solo = ServeEngine(cfg, model, batch_slots=1, cache_len=32, device="cpu")
    solo.submit(Request(uid=0, prompt=[7, 11, 13], max_new_tokens=6))
    want = solo.run_until_drained()[0].output
    batched = ServeEngine(cfg, model, batch_slots=4, cache_len=32, device="cpu")
    for uid, p0 in enumerate([3, 7, 9, 21]):
        batched.submit(Request(uid=uid, prompt=[p0, 11, 13], max_new_tokens=6))
    got = next(r for r in batched.run_until_drained() if r.uid == 1).output
    assert got == want


def test_bf16_smoke_forward_within_bf16_tolerance():
    rcfg, cfg = _cfgs("bfloat16")
    params = r_lm.init_params(rcfg, jax.random.key(1))
    model = interop.lm_params_from_numpy(cfg, _np(params), device="cpu")
    assert model.embed.dtype == torch.bfloat16
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 128)).astype(np.int32)
    want = jax.jit(lambda p, t: r_lm.forward_logits(rcfg, p, dict(tokens=t), use_pallas=True))(
        params, jnp.asarray(tokens))
    got = lm.forward_logits(cfg, model, dict(tokens=torch.from_numpy(tokens)), use_kernel=True)
    # bf16 activations round at 2^-8 relative in both frameworks, at
    # different places (matmul outputs, silu, residual adds) over 2
    # layers.  The logits are O(1) and themselves bf16 matmul outputs, so
    # one bf16 step there is 2^-7 ≈ 8e-3: the mean difference stays
    # within about one step, the largest within a few
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=5e-2, atol=5e-2)
    assert np.abs(got.numpy() - _f32(want)).mean() < 1e-2


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen2.5-32b", "starcoder2-7b",
                                  "qwen1.5-32b"])
def test_dense_smoke_configs_run(arch):
    # every dense config of the registry: bias, GELU, windows and tied heads
    cfg = replace(get_smoke(arch), dtype="float32")
    model = lm.LM(cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, 128)))
    loss, _ = lm.forward_loss(cfg, model, dict(tokens=tokens, labels=tokens.roll(-1, 1)),
                              use_kernel=True)
    assert np.isfinite(float(loss))


def test_launch_serve_smoke_on_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "granite-3-8b", "--smoke", "--batch", "2", "--tokens", "3",
                       "--device", "cpu"]) == 0
    assert "2 streams × 3 tokens" in capsys.readouterr().out


def test_lm_and_decode_state_without_device_raise_on_a_cardless_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = replace(get_smoke("granite-3-8b"), dtype="float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.LM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_decode_state(cfg, 1, 8)


def test_lm_params_from_numpy_without_device_raises_on_a_cardless_host(lm_pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg, params, _, _, _ = lm_pair
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.lm_params_from_numpy(cfg, params)


def test_launch_serve_without_device_raises_on_a_cardless_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    code = "from repro_torch.launch import serve; serve.main(['--arch', 'granite-3-8b', '--smoke'])"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
