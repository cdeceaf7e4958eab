"""The port's MoE family against the JAX package's, on the CPU: ``moe_ffn``
in every dispatch mode, with and without shared experts, with drops and
without, at a capacity that rounds half to even and one that ``"ep"``
pads; then the whole smoke LM of both MoE configs (weights carried both
ways, logits, the loss with its aux terms, decode, serving, one train
step), on inputs made with numpy and weights carried by ``interop``.

Every comparison first asserts that the routes are equal: the experts
each token picked (in order) and which slots were kept.  Then values:

* ``moe_ffn`` in float32: atol 2e-4, rtol 1e-3 (the reference's own
  decode-vs-prefill tolerance, ``tests/test_archs.py``); the aux terms
  within 1e-6 (float32 sums of O(1) terms in another order);
* in bfloat16: atol and rtol 3e-2, mean difference below 2^-8.  Both
  round each product and the SwiGLU to bf16 (2^-8 relative) at different
  places, so an output may land a bf16 step away: outputs reach about 5,
  where one step is 2^-5 ≈ 3e-2; over the whole output the mean stays
  below half a step at 1;
* the LM's logits, loss and decode in float32 at atol 2e-4, rtol 1e-3;
  serving token ids equal; one train step's updated parameters at the
  reference's resume tolerance (atol 1e-5, rtol 1e-4), as
  ``tests/test_torch_train.py`` holds the dense step.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import get_smoke as r_get_smoke
from repro.models import lm as r_lm
from repro.models import moe as r_moe
from repro.models.steps import make_train_step as r_make_train_step
from repro.optim import adamw_init as r_adamw_init
from repro.roofline import analysis as r_roofline
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine

from repro_torch import interop
from repro_torch.configs import SHAPES, get_config, get_smoke
from repro_torch.data import synthetic_batch
from repro_torch.models import lm, moe
from repro_torch.models.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.optim import adamw_init
from repro_torch.roofline import model_flops
from repro_torch.serve import Request, ServeEngine

F32_TOL = dict(atol=2e-4, rtol=1e-3)
AUX_TOL = dict(atol=1e-6, rtol=1e-6)
STEP_TOL = dict(atol=1e-5, rtol=1e-4)
ARCHS = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]
# the smoke configs' MoE width: d 64, E 8, K 2, f 64
D, E, K, F = 64, 8, 2, 64


# ---------------------------------------------------------------- moe_ffn


def _moe_params(rng, shared: bool) -> dict:
    shapes = dict(router=(D, E), w_gate=(E, D, F), w_up=(E, D, F), w_down=(E, F, D))
    if shared:
        shapes.update(sh_gate=(D, F), sh_up=(D, F), sh_down=(F, D))
    return {k: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
            for k, s in shapes.items()}


def _port_moe(params: dict, dtype) -> moe.MoE:
    m = moe.MoE(D, E, F, int("sh_gate" in params), dtype, device="cpu")
    with torch.no_grad():
        for k, v in params.items():
            getattr(m, k).copy_(torch.from_numpy(np.array(v)))
    return m


def _ref_routes(params: dict, x: np.ndarray, cap: int):
    """The reference's routing (its einsum, softmax and ``lax.top_k``) and,
    from it, the kept slots counted in numpy in k-major order."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1]).astype(jnp.float32)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf, jnp.asarray(params["router"])), -1)
    idx = np.asarray(jax.lax.top_k(probs, K)[1])
    seen = np.zeros(E, np.int64)
    keep = []
    for e in idx.T.reshape(-1):
        keep.append(seen[e] < cap)
        seen[e] += 1
    return idx, np.array(keep)


# (batch, seq, dispatch mode, shared experts, capacity factor)
MOE_CASES = [(2, 16, mode, shared, cf) for mode in moe.DISPATCH_MODES
             for shared in (True, False) for cf in (1.25, 8.0)]
# T·K/E·cf = 8·2/8·1.25 = 2.5, which Python's round takes to 2 (half to even)
MOE_CASES += [(1, 8, "auto", True, 1.25), (1, 8, "ep", False, 1.25)]
# cap 1024·2/8·1.25 = 320 > 256: "ep" pads it to 512, "auto" keeps 320
MOE_CASES += [(4, 256, "ep", True, 1.25), (4, 256, "auto", True, 1.25)]


@pytest.mark.parametrize("b,s,mode,shared,cf", MOE_CASES)
def test_moe_ffn_matches_the_reference(b, s, mode, shared, cf):
    rng = np.random.default_rng(b * 1000 + s + int(shared) + int(cf))
    params = _moe_params(rng, shared)
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    t = b * s
    cap = moe.capacity(t, K, E, cf, mode)
    want_cap = {(8, 1.25): 2, (1024, 1.25): 512 if mode == "ep" else 320}.get((t, cf))
    if want_cap is not None:
        assert cap == want_cap
    assert cap == int(max(1, round(t * K / E * cf))) or (mode == "ep" and cap % 256 == 0)

    m = _port_moe(params, torch.float32)
    xt = torch.from_numpy(x)
    _, _, _, idx = moe.route(xt.reshape(t, D), m.router, K)
    keep, _ = moe.slots(idx, E, cap)
    want_idx, want_keep = _ref_routes(params, x, cap)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if cf == 1.25 and t <= 32:
        assert not want_keep.all()          # the case drops slots
    if cf == 8.0:
        assert want_keep.all()

    want, waux = r_moe.moe_ffn({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
                               top_k=K, capacity_factor=cf, dispatch_sharding=mode)
    with torch.no_grad():
        got, aux = moe.moe_ffn(m, xt, top_k=K, capacity_factor=cf, dispatch_sharding=mode)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    for key in ("load_balance", "z_loss"):
        np.testing.assert_allclose(float(aux[key]), float(waux[key]), **AUX_TOL, err_msg=key)


def test_moe_ffn_bf16_within_bf16_tolerance():
    rng = np.random.default_rng(7)
    params = _moe_params(rng, True)
    x = rng.standard_normal((2, 32, D)).astype(np.float32)
    jp = {k: jnp.asarray(v).astype(jnp.float32 if k == "router" else jnp.bfloat16)
          for k, v in params.items()}
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    m = _port_moe({k: np.asarray(v.astype(jnp.float32)) for k, v in jp.items()}, torch.bfloat16)
    assert m.router.dtype == torch.float32 and m.w_gate.dtype == torch.bfloat16
    xt = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)
    cap = moe.capacity(64, K, E, 1.25)
    _, _, _, idx = moe.route(xt.reshape(64, D), m.router, K)
    want_idx, want_keep = _ref_routes({"router": params["router"]},
                                      np.asarray(jx.astype(jnp.float32)), cap)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(moe.slots(idx, E, cap)[0].numpy(), want_keep)
    want, waux = r_moe.moe_ffn(jp, jx, top_k=K, capacity_factor=1.25)
    with torch.no_grad():
        got, aux = moe.moe_ffn(m, xt, top_k=K, capacity_factor=1.25)
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)
    assert np.abs(got - want).mean() < 2.0**-8
    for key in ("load_balance", "z_loss"):     # the router runs in float32 on both sides
        np.testing.assert_allclose(float(aux[key]), float(waux[key]), **AUX_TOL, err_msg=key)


def test_auto_ep_computes_auto_in_both_packages():
    """``"auto_ep"`` (a mode the reference's configs name, whose only
    effect there is the EP-only sharding rules) computes ``"auto"`` in
    both packages, bit for bit within each, without a mesh."""
    rng = np.random.default_rng(3)
    params = _moe_params(rng, True)
    x = rng.standard_normal((2, 16, D)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref = {mode: r_moe.moe_ffn(jp, jnp.asarray(x), top_k=K, capacity_factor=1.0,
                               dispatch_sharding=mode) for mode in ("auto", "auto_ep")}
    m = _port_moe(params, torch.float32)
    with torch.no_grad():
        got = {mode: moe.moe_ffn(m, torch.from_numpy(x), top_k=K, capacity_factor=1.0,
                                 dispatch_sharding=mode) for mode in ("auto", "auto_ep")}
    np.testing.assert_array_equal(np.asarray(ref["auto_ep"][0]), np.asarray(ref["auto"][0]))
    assert torch.equal(got["auto_ep"][0], got["auto"][0])
    for key in ("load_balance", "z_loss"):
        assert float(got["auto_ep"][1][key]) == float(got["auto"][1][key])
    np.testing.assert_allclose(got["auto_ep"][0].numpy(), np.asarray(ref["auto_ep"][0]),
                               **F32_TOL)


def test_moe_ffn_rejects_an_unknown_dispatch_mode():
    m = _port_moe(_moe_params(np.random.default_rng(0), False), torch.float32)
    with pytest.raises(ValueError, match="dispatch_sharding"):
        moe.moe_ffn(m, torch.zeros(1, 4, D), top_k=K, dispatch_sharding="expert")


# ---------------------------------------------------------------- whole LM


def _cfgs(arch, dtype="float32", **kw):
    return (replace(r_get_smoke(arch), dtype=dtype, **kw),
            replace(get_smoke(arch), dtype=dtype, **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def moe_pair(request):
    rcfg, cfg = _cfgs(request.param)
    params = _np(r_lm.init_params(rcfg, jax.random.key(0)))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    return (rcfg, cfg, params, interop.lm_params_from_numpy(cfg, params, device="cpu"),
            tokens, np.roll(tokens, -1, axis=1))


class _Routes:
    """The routes of each MoE call, in call order: the reference's from a
    ``jax.debug.callback`` beside its ``moe_ffn``, the port's from
    ``moe.route``."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        r_ffn, p_route = r_moe.moe_ffn, moe.route

        def ref_ffn(p, x, *, top_k, **kw):
            xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
            probs = jax.nn.softmax(jnp.einsum("td,de->te", xf, p["router"]), -1)
            jax.debug.callback(lambda i: self.ref.append(np.asarray(i)),
                               jax.lax.top_k(probs, top_k)[1], ordered=True)
            return r_ffn(p, x, top_k=top_k, **kw)

        def port_route(xf, router, top_k):
            out = p_route(xf, router, top_k)
            self.port.append(out[3].numpy().copy())
            return out

        monkeypatch.setattr(r_lm, "moe_ffn", ref_ffn)
        monkeypatch.setattr(moe, "route", port_route)

    def check(self, n):
        jax.effects_barrier()
        assert len(self.ref) == len(self.port) == n
        for a, b in zip(self.port, self.ref):
            np.testing.assert_array_equal(a, b)


def test_lm_params_carry_both_ways(moe_pair):
    rcfg, cfg, params, model, _, _ = moe_pair
    assert sum(p.numel() for p in model.parameters()) == \
        sum(a.size for a in jax.tree.leaves(params))
    for key in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(getattr(model.layers[1].moe, key).detach().numpy(),
                                      params["layers"]["moe"][key][1])
    assert ("sh_gate" in params["layers"]["moe"]) == bool(cfg.n_shared_experts) \
        == model.layers[0].moe.shared
    back = interop.lm_params_to_numpy(cfg, model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_lm_keeps_the_router_float32(arch):
    rcfg, cfg = _cfgs(arch, "bfloat16")
    params = r_lm.init_params(rcfg, jax.random.key(2))
    assert params["layers"]["moe"]["router"].dtype == jnp.float32
    model = interop.lm_params_from_numpy(cfg, _np(params), device="cpu")
    assert model.layers[0].moe.router.dtype == torch.float32
    assert model.layers[0].moe.w_gate.dtype == model.embed.dtype == torch.bfloat16
    assert lm.LM(cfg, device="cpu").layers[1].moe.router.dtype == torch.float32
    for a, b in zip(jax.tree.leaves(interop.lm_params_to_numpy(cfg, model)),
                    jax.tree.leaves(_np(jax.tree.map(lambda v: v.astype(jnp.float32), params)))):
        np.testing.assert_array_equal(a, b)


def test_forward_logits_matches(moe_pair, monkeypatch):
    rcfg, cfg, params, model, tokens, _ = moe_pair
    routes = _Routes(monkeypatch)
    want = jax.jit(lambda p, t: r_lm.forward_logits(rcfg, p, dict(tokens=t)))(params, tokens)
    got = lm.forward_logits(cfg, model, dict(tokens=torch.from_numpy(tokens)), use_kernel=True)
    routes.check(cfg.n_layers)
    assert got.shape == (2, 32, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_forward_loss_and_aux_match(moe_pair, monkeypatch):
    rcfg, cfg, params, model, tokens, labels = moe_pair
    routes = _Routes(monkeypatch)
    _, want = jax.jit(lambda p, t, y: r_lm.forward_loss(rcfg, p, dict(tokens=t, labels=y)))(
        params, tokens, labels)
    got = make_prefill_step(cfg, use_kernel=True)(
        model, dict(tokens=torch.from_numpy(tokens), labels=torch.from_numpy(labels)))
    routes.check(cfg.n_layers)
    assert set(got) == set(want) == {"loss", "nll", "load_balance", "z_loss"}
    for key in ("loss", "nll"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), **F32_TOL, err_msg=key)
    for key in ("load_balance", "z_loss"):   # summed over the layers
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)
    extra = 0.01 * float(got["load_balance"]) + 0.001 * float(got["z_loss"])
    np.testing.assert_allclose(float(got["loss"]), float(got["nll"]) + extra, rtol=1e-6)
    assert abs(float(got["nll"]) - np.log(cfg.vocab)) < 1.5


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_reference_and_prefill(arch, monkeypatch):
    # no-drop routing, as the reference's own decode test runs the MoE configs
    rcfg, cfg = _cfgs(arch, capacity_factor=8.0)
    params = _np(r_lm.init_params(rcfg, jax.random.key(1)))
    model = interop.lm_params_from_numpy(cfg, params, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    prefill = lm.forward_logits(cfg, model, dict(tokens=torch.from_numpy(tokens)))
    routes = _Routes(monkeypatch)
    rstep = jax.jit(lambda p, s, t: r_lm.decode_step(rcfg, p, s, t))
    rstate = r_lm.init_decode_state(rcfg, 2, 16)
    step = make_serve_step(cfg)
    with torch.inference_mode():
        state = lm.init_decode_state(cfg, 2, 16, device="cpu")
    for t in range(12):
        want, rstate = rstep(params, rstate, jnp.asarray(tokens[:, t]))
        got, state = step(model, state, dict(tokens=torch.from_numpy(tokens[:, t])))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        np.testing.assert_allclose(got.numpy(), prefill[:, t].numpy(), **F32_TOL)
    routes.check(12 * cfg.n_layers)
    assert int(state["pos"]) == int(rstate["pos"]) == 12


def _requests(mk):
    return [mk(uid=0, prompt=[5, 9, 2], max_new_tokens=6),
            mk(uid=1, prompt=[7, 11, 13, 1, 4], max_new_tokens=4),
            mk(uid=2, prompt=[3], max_new_tokens=20),             # truncated by the cache
            mk(uid=3, prompt=[8, 8], max_new_tokens=5)]


def test_serve_engine_token_ids_equal_the_reference_with_drops(moe_pair, monkeypatch):
    # cf 1.25 at 3 slots: cap = max(1, round(3·2/8·1.25)) = 1, so two slots
    # bound for one expert collide and the second is dropped, on both sides
    rcfg, cfg, params, model, _, _ = moe_pair
    dropped = []
    p_slots = moe.slots

    def counting_slots(idx, n_experts, cap):
        keep, slot = p_slots(idx, n_experts, cap)
        dropped.append(int((~keep).sum()))
        return keep, slot

    monkeypatch.setattr(moe, "slots", counting_slots)
    reng = RServeEngine(rcfg, params, batch_slots=3, cache_len=16)
    eng = ServeEngine(cfg, model, batch_slots=3, cache_len=16, device="cpu")
    for r, t in zip(_requests(RRequest), _requests(Request)):
        reng.submit(r)
        eng.submit(t)
    want = {r.uid: (r.output, r.truncated) for r in reng.run_until_drained()}
    got = {r.uid: (r.output, r.truncated) for r in eng.run_until_drained()}
    assert got == want
    assert eng.steps_executed == reng.steps_executed
    assert sum(dropped) > 0


def test_serve_engine_batch_equals_solo_without_drops():
    _, cfg = _cfgs("deepseek-moe-16b", capacity_factor=8.0)
    model = lm.LM(cfg, device="cpu")
    solo = ServeEngine(cfg, model, batch_slots=1, cache_len=32, device="cpu")
    solo.submit(Request(uid=0, prompt=[7, 11, 13], max_new_tokens=6))
    want = solo.run_until_drained()[0].output
    batched = ServeEngine(cfg, model, batch_slots=4, cache_len=32, device="cpu")
    for uid, p0 in enumerate([3, 7, 9, 21]):
        batched.submit(Request(uid=uid, prompt=[p0, 11, 13], max_new_tokens=6))
    assert next(r for r in batched.run_until_drained() if r.uid == 1).output == want


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch):
    rcfg, cfg = _cfgs(arch)
    params = _np(r_lm.init_params(rcfg, jax.random.key(3)))
    model = interop.lm_params_from_numpy(cfg, params, device="cpu")
    kw = dict(base_lr=1e-3, total_steps=10, warmup_steps=2)
    batch = synthetic_batch(0, 0, 4, 16, cfg.vocab)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = jax.jit(jax.grad(lambda p, b: r_lm.forward_loss(rcfg, p, b)[0]))(params, jbatch)
    jparams, _, want = jax.jit(r_make_train_step(rcfg, **kw))(
        params, r_adamw_init(params), jbatch, jnp.int32(0))
    _, got = make_train_step(cfg, **kw)(model, adamw_init(model), batch, 0)
    assert set(got) == set(want) == {"loss", "nll", "load_balance", "z_loss", "grad_norm", "lr"}
    for key in ("loss", "nll", "grad_norm", "load_balance", "z_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, err_msg=key)
    # an element whose gradient is within 100x Adam's eps moves steeply with
    # it: held to twice the learning rate (tests/test_torch_train.py)
    lr = float(want["lr"])
    flat_want = dict(jax.tree_util.tree_leaves_with_path(_np(jparams)))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(_np(grads)))
    for path, a in jax.tree_util.tree_leaves_with_path(interop.lm_params_to_numpy(cfg, model)):
        w, g = flat_want[path], flat_g[path]
        limit = np.where((np.abs(g) < 1e-6) & (g != 0), 2 * lr,
                         STEP_TOL["atol"] + STEP_TOL["rtol"] * np.abs(w))
        assert not (np.abs(a - w) > limit).any(), (jax.tree_util.keystr(path),
                                                   float(np.abs(a - w).max()))


def _grads(cfg, model, batch):
    loss, _ = lm.forward_loss(cfg, model, batch)
    return torch.autograd.grad(loss, list(model.parameters()))


def test_remat_policies_give_equal_gradients(monkeypatch):
    _, cfg = _cfgs("deepseek-moe-16b")
    model = lm.LM(cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(1, 0, 2, 32, cfg.vocab).items()}
    full = _grads(cfg, model, batch)
    save = _grads(replace(cfg, remat_policy="save_attn"), model, batch)
    monkeypatch.setattr(lm, "checkpoint", lambda fn, *a, **kw: fn(*a))   # no remat
    none = _grads(cfg, model, batch)
    assert all(float(g.abs().max()) > 0 for g in none[-3:])
    for a, b, c in zip(full, save, none):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(b, c, rtol=1e-6, atol=1e-9)


def test_model_flops_match_the_reference():
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), r_get_config(arch)
        assert cfg.active_param_count() == rcfg.active_param_count()
        for shape in SHAPES.values():
            assert model_flops(cfg, shape) == r_roofline.model_flops(rcfg, shape)
    assert round(get_config("deepseek-moe-16b").active_param_count() / 1e9, 2) == 2.83
    assert round(get_config("deepseek-moe-16b").param_count() / 1e9, 2) == 16.88


def test_launch_serve_moe_smoke_on_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "deepseek-moe-16b", "--smoke", "--batch", "2", "--tokens", "3",
                       "--device", "cpu"]) == 0
    assert "2 streams × 3 tokens" in capsys.readouterr().out
