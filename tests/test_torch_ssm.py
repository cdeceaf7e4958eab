"""The port's recurrent mixers and the hybrid and ssm families against the
JAX package's, on the CPU, on inputs made with numpy and weights carried
from the reference's initialisers.

Mixers: Mamba (``mamba_seq``, ``mamba_seq_assoc``, ``mamba_step`` with
its state and conv buffer), mLSTM (``mlstm_seq``, ``mlstm_seq_chunked``,
``mlstm_step``) and sLSTM (``slstm_seq``, ``slstm_step``) at the
reference's own shapes (``tests/test_ssm_impls.py``) and at S = 512,
where both packages scan in checkpointed 256-step chunks; there also the
parameters' gradients against ``jax.grad``.  The mLSTM's sequence forms
are also held to a float64 evaluation of the recurrence.

Then hymba-1.5b-smoke (also at ``attn_window=8``, so that decode wraps
the ring cache) and xlstm-smoke whole: weights carried both ways (the
float32 parameters stay float32 under bf16), logits and loss under both
impls of each, decode against the reference's decode and against
prefill, serving token ids, one train step (the ssm family's unused
branch decays as the reference's does), both remat policies, training
that lowers the loss, ``param_count``/``model_flops`` and
``launch.serve``.

Tolerances:

* a mixer in float32: atol 1e-5, rtol 1e-4 (the reference's own bound
  between its Mamba forms).  The mLSTM's sequence forms cannot meet it
  between any two float32 evaluations (see the test), so there the port
  is held to the reference's bound between its two forms (max error below
  1e-3 of max |y|) and must lie no further from float64 than the
  reference;
* gradients (S = 512): the largest difference over all of a mixer's
  gradients below 1e-5 of the largest gradient (each is a float32 sum of
  512 steps' terms in another order); the mLSTM's within 1e-3 of it, of
  the reference's and of a float64 autograd (its output's bound above);
* a mixer in bfloat16: atol and rtol 5e-2, mean difference below 2^-7.
  Both round the projections, the convolution and the gated output to
  bf16 (2^-8 relative) at different places, the recurrences in float32;
  outputs reach about 3, where one bf16 step is 2^-7 ≈ 8e-3;
* the LM's logits, loss and decode in float32 at atol 2e-4, rtol 1e-3
  (the reference's decode-vs-prefill tolerance, ``tests/test_archs.py``),
  the chunkwise mLSTM against the scan at rtol 1e-4
  (``tests/test_ssm_impls.py``); serving token ids equal; one train
  step's updated parameters at the reference's resume tolerance (atol
  1e-5, rtol 1e-4), as ``tests/test_torch_moe.py`` holds the MoE's.
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
from repro.models import ssm as r_ssm
from repro.models.steps import make_train_step as r_make_train_step
from repro.optim import adamw_init as r_adamw_init
from repro.roofline import analysis as r_roofline
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine

from repro_torch import interop
from repro_torch.configs import SHAPES, get_config, get_smoke, list_archs
from repro_torch.data import synthetic_batch
from repro_torch.models import lm, ssm
from repro_torch.models.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.optim import adamw_init
from repro_torch.roofline import model_flops
from repro_torch.serve import Request, ServeEngine

MIX_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
F32_TOL = dict(atol=2e-4, rtol=1e-3)
STEP_TOL = dict(atol=1e-5, rtol=1e-4)
ARCHS = ["hymba-1.5b", "xlstm-1.3b"]
#: the float32 parameters of each mixer under any config dtype
F32_PARAMS = {"mamba": {"a_log", "dt_bias", "d_skip"}, "mlstm": {"wi", "wf", "bf", "bi"},
              "slstm": {"wi", "wf", "bf", "bi", "rz"}}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------- mixers


def _mixer(kind: str, d: int, n: int, dtype=jnp.float32):
    """The reference's parameters of one mixer (n: d_state or heads) and
    the port's module holding the same values."""
    key = jax.random.key(d + n)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    if kind == "mamba":
        params = r_ssm.init_mamba(key, d, n, 4, dtype=dtype)
        mod = ssm.Mamba(d, n, 4, tdt, device="cpu")
    elif kind == "mlstm":
        params = r_ssm.init_mlstm(key, d, n, dtype=dtype)
        mod = ssm.MLSTM(d, n, tdt, device="cpu")
    else:
        params = r_ssm.init_slstm(key, d, n, dtype=dtype)
        mod = ssm.SLSTM(d, n, tdt, device="cpu")
    assert {k for k, _ in mod.named_parameters()} == set(params)
    with torch.no_grad():
        for k, v in params.items():
            t = getattr(mod, k)
            assert t.dtype == (torch.float32 if k in F32_PARAMS[kind] else tdt), k
            assert v.dtype == (jnp.float32 if k in F32_PARAMS[kind] else dtype), k
            t.copy_(torch.from_numpy(_f32(v)))
    return params, mod


#: (mixer, form) → (the reference's function, the port's, keyword)
SEQ_FORMS = {
    ("mamba", "scan"): (r_ssm.mamba_seq, ssm.mamba_seq, "d_state"),
    ("mamba", "assoc"): (r_ssm.mamba_seq_assoc, ssm.mamba_seq_assoc, "d_state"),
    ("mlstm", "scan"): (r_ssm.mlstm_seq, ssm.mlstm_seq, "n_heads"),
    ("mlstm", "chunked"): (r_ssm.mlstm_seq_chunked, ssm.mlstm_seq_chunked, "n_heads"),
    ("slstm", "scan"): (r_ssm.slstm_seq, ssm.slstm_seq, "n_heads"),
}
# (b, s, d, n[, chunk]): tests/test_ssm_impls.py's shapes, then S = 512, which
# both packages scan in two checkpointed 256-step chunks
MAMBA_SHAPES = [(2, 64, 32, 8), (1, 128, 64, 16), (1, 512, 32, 8)]
XLSTM_SHAPES = [(2, 128, 64, 4, 32), (1, 256, 128, 4, 64), (1, 512, 64, 4, 64)]
SEQ_CASES = ([("mamba", f, shp) for f in ("scan", "assoc") for shp in MAMBA_SHAPES]
             + [("mlstm", f, shp) for f in ("scan", "chunked") for shp in XLSTM_SHAPES]
             + [("slstm", "scan", shp) for shp in XLSTM_SHAPES])


def _seq_call(kind, form, shp):
    ref_fn, port_fn, name = SEQ_FORMS[kind, form]
    kw = {name: shp[3]}
    if form == "chunked":
        kw["chunk"] = shp[4]
    return ref_fn, port_fn, kw


def _mlstm_f64(params, x, n_heads, w=None):
    """The mLSTM recurrence (``_mlstm_cell`` step by step) in float64: the
    output, or with ``w`` the gradients of ``sum(y·w)`` by autograd
    (keyed as the parameters, and ``x``)."""
    p = {k: torch.tensor(np.asarray(v), dtype=torch.float64, requires_grad=w is not None)
         for k, v in params.items()}
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=w is not None)
    b, s, d = x.shape
    dh = d // n_heads
    q, k, v = ((xt @ p[name]).reshape(b, s, n_heads, dh) for name in ("wq", "wk", "wv"))
    k = k * dh ** -0.5
    i_pre, f_pre = xt @ p["wi"] + p["bi"], xt @ p["wf"] + p["bf"]
    st = {key: a.double()
          for key, a in ssm.mlstm_init_state(b, n_heads, dh, device="cpu").items()}
    hs = []
    for t in range(s):
        st, h = ssm._mlstm_cell(st, q[:, t], k[:, t], v[:, t], i_pre[:, t], f_pre[:, t])
        hs.append(h)
    y = (torch.stack(hs, 1).reshape(b, s, d) * torch.sigmoid(xt @ p["ogate"])) @ p["wo"]
    if w is None:
        return y.detach().numpy()
    (y * torch.from_numpy(w).double()).sum().backward()
    return {**{key: a.grad.numpy() for key, a in p.items()}, "x": xt.grad.numpy()}


def _tol_share(a, exact) -> float:
    """The largest share of MIX_TOL that ``a`` uses against ``exact``."""
    return float((np.abs(a - exact) / (MIX_TOL["atol"] + MIX_TOL["rtol"] * np.abs(exact))).max())


@pytest.mark.parametrize("kind,form,shp", SEQ_CASES)
def test_seq_mixer_matches_the_reference(kind, form, shp):
    b, s, d, n = shp[:4]
    params, mod = _mixer(kind, d, n)
    x = np.random.default_rng(s + d).standard_normal((b, s, d)).astype(np.float32)
    ref_fn, port_fn, kw = _seq_call(kind, form, shp)
    want = np.asarray(jax.jit(lambda p, x: ref_fn(p, x, **kw))(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port_fn(mod, torch.from_numpy(x), **kw)
    assert got.shape == x.shape and got.dtype == torch.float32
    got = got.numpy()
    if kind != "mlstm":
        np.testing.assert_allclose(got, want, **MIX_TOL)
        return
    # The mLSTM's read-out divides by max(|n·q|, e^-m), and |n·q| falls to 4e-4
    # on these inputs: no two float32 evaluations of it in different orders meet
    # MIX_TOL element by element.  The reference's own scan and chunked forms
    # differ by 4.5-17x it, and each lies 3.6-17x it from float64.  So the port
    # is held to the reference's bound between its two forms (max error below
    # 1e-3 of max |y|, tests/test_ssm_impls.py) and to the float64 recurrence:
    # no further from it than the reference is
    assert float(np.abs(got - want).max()) < 1e-3 * float(np.abs(want).max())
    exact = _mlstm_f64(params, x, n)
    assert _tol_share(got, exact) <= 1.25 * max(1.0, _tol_share(want, exact)), (
        _tol_share(got, exact), _tol_share(want, exact))


def _grad_error(got: dict, want: dict) -> float:
    """The largest gradient difference over every tensor, as a share of the
    largest gradient: a gradient that is zero in exact arithmetic (the
    sLSTM's ``bi``, which cancels in c/n) is rounding noise on both sides."""
    return (max(float(np.abs(got[k] - want[k]).max()) for k in want)
            / max(float(np.abs(a).max()) for a in want.values()))


@pytest.mark.parametrize("kind,form", sorted(SEQ_FORMS))
def test_seq_mixer_gradients_match_jax_grad(kind, form):
    # S = 512: the port's backward goes through its checkpointed 256-step
    # chunks, the reference's through its jax.checkpoint chunks
    shp = (1, 512, 32, 8) if kind == "mamba" else (1, 512, 32, 2, 64)
    b, s, d, n = shp[:4]
    params, mod = _mixer(kind, d, n)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((b, s, d)).astype(np.float32)
    ref_fn, port_fn, kw = _seq_call(kind, form, shp)
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(ref_fn(p, x, **kw) * w), argnums=(0, 1)))(
        params, jnp.asarray(x))
    want = {**_np(gp), "x": np.asarray(gx)}
    xt = torch.from_numpy(x).requires_grad_()
    (port_fn(mod, xt, **kw) * torch.from_numpy(w)).sum().backward()
    got = {**{k: getattr(mod, k).grad.numpy() for k in gp}, "x": xt.grad.numpy()}
    if kind != "mlstm":
        # float32 sums of 512 steps' terms in other orders: 3e-7 to 1e-6 measured
        assert _grad_error(got, want) < 1e-5
        return
    # the mLSTM's gradients inherit its read-out's conditioning (see above), and
    # bf's (-1458) is a sum of large stabiliser terms that cancel: every float32
    # evaluation scatters about float64 (the reference's scan 8.4e-5 and chunked
    # form 7.4e-4 of the largest gradient, the port's 2.0e-4 and 9.4e-4), so
    # both are held to the reference's own bound between its two forms
    assert _grad_error(got, want) < 1e-3
    assert _grad_error(got, _mlstm_f64(params, x, n, w)) < 1e-3


@pytest.mark.parametrize("kind,form", [("mamba", "scan"), ("mamba", "assoc"),
                                       ("mlstm", "chunked"), ("slstm", "scan")])
def test_seq_mixer_bf16_within_bf16_tolerance(kind, form):
    shp = (2, 64, 32, 8) if kind == "mamba" else (2, 64, 64, 4, 16)
    b, s, d, n = shp[:4]
    params, mod = _mixer(kind, d, n, jnp.bfloat16)
    x = jnp.asarray(np.random.default_rng(3).standard_normal((b, s, d))).astype(jnp.bfloat16)
    ref_fn, port_fn, kw = _seq_call(kind, form, shp)
    want = _f32(jax.jit(lambda p, x: ref_fn(p, x, **kw))(params, x))
    with torch.no_grad():
        got = port_fn(mod, torch.from_numpy(_f32(x)).to(torch.bfloat16), **kw)
    assert got.dtype == torch.bfloat16
    got = _f32(got)
    np.testing.assert_allclose(got, want, **BF16_TOL)
    assert np.abs(got - want).mean() < 2.0**-7


def test_mlstm_chunked_rejects_a_chunk_that_does_not_divide():
    _, mod = _mixer("mlstm", 32, 2)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ssm.mlstm_seq_chunked(mod, torch.zeros(1, 48, 32), n_heads=2, chunk=32)


def _random_state(rng, kind, b, d, n):
    """A carried state away from zero (m from a normal draw)."""
    if kind == "mamba":
        st = dict(h=rng.standard_normal((b, d, n)), conv=rng.standard_normal((b, 3, d)))
        return {k: v.astype(np.float32) for k, v in st.items()}
    dh = d // n
    st = dict(c=rng.standard_normal((b, n, dh, dh) if kind == "mlstm" else (b, n, dh)),
              n=rng.standard_normal((b, n, dh)), m=rng.standard_normal((b, n)))
    if kind == "slstm":
        st["h"] = rng.standard_normal((b, n, dh))
    return {k: v.astype(np.float32) for k, v in st.items()}


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
@pytest.mark.parametrize("start", ["zero", "random"])
def test_step_mixer_matches_the_reference(kind, start):
    b, d, n = 2, 32, (8 if kind == "mamba" else 4)
    params, mod = _mixer(kind, d, n)
    rng = np.random.default_rng(11)
    if start == "random":
        st = _random_state(rng, kind, b, d, n)
    elif kind == "mamba":
        st = dict(h=np.zeros((b, d, n), np.float32), conv=np.zeros((b, 3, d), np.float32))
    else:
        init = r_ssm.mlstm_init_state if kind == "mlstm" else r_ssm.slstm_init_state
        st = _np(init(b, n, d // n))
    rst = {k: jnp.asarray(v) for k, v in st.items()}
    pst = {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
    if kind == "mamba":
        rstep = jax.jit(lambda p, x, s: r_ssm.mamba_step(p, x, s["h"], s["conv"], d_state=n))
    else:
        fn = r_ssm.mlstm_step if kind == "mlstm" else r_ssm.slstm_step
        rstep = jax.jit(lambda p, x, s: fn(p, x, s, n_heads=n))
    for t in range(8):
        x = rng.standard_normal((b, 1, d)).astype(np.float32)
        out = rstep(params, jnp.asarray(x), rst)
        with torch.no_grad():
            if kind == "mamba":
                got, h, conv = ssm.mamba_step(mod, torch.from_numpy(x), pst["h"], pst["conv"],
                                              d_state=n)
                pst, rst = dict(h=h, conv=conv), dict(h=out[1], conv=out[2])
            else:
                step = ssm.mlstm_step if kind == "mlstm" else ssm.slstm_step
                got, pst = step(mod, torch.from_numpy(x), pst, n_heads=n)
                rst = out[1]
        np.testing.assert_allclose(got.numpy(), np.asarray(out[0]), **MIX_TOL,
                                   err_msg=f"step {t}")
        for k, v in pst.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(rst[k]), **MIX_TOL,
                                       err_msg=f"step {t}: {k}")


# ---------------------------------------------------------------- whole LM


def _cfgs(arch, dtype="float32", **kw):
    return (replace(r_get_smoke(arch), dtype=dtype, **kw),
            replace(get_smoke(arch), dtype=dtype, **kw))


@pytest.fixture(scope="module", params=ARCHS)
def ssm_pair(request):
    rcfg, cfg = _cfgs(request.param)
    params = _np(r_lm.init_params(rcfg, jax.random.key(0)))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 64)).astype(np.int32)
    return (rcfg, cfg, params, interop.lm_params_from_numpy(cfg, params, device="cpu"),
            tokens, np.roll(tokens, -1, axis=1))


def test_lm_params_carry_both_ways(ssm_pair):
    rcfg, cfg, params, model, _, _ = ssm_pair
    assert sum(p.numel() for p in model.parameters()) == \
        sum(a.size for a in jax.tree.leaves(params))
    mixers = ("mlstm", "slstm") if cfg.family == "ssm" else ("mamba",)
    for name in mixers:
        for key, a in params["layers"][name].items():
            np.testing.assert_array_equal(_f32(getattr(getattr(model.layers[1], name), key)),
                                          a[1], err_msg=f"{name}.{key}")
    if cfg.family == "ssm":    # ln1 and the two mixers, nothing else
        assert set(params["layers"]) == {"ln1", "mlstm", "slstm"}
    back = interop.lm_params_to_numpy(cfg, model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_lm_keeps_the_float32_parameters(arch):
    rcfg, cfg = _cfgs(arch, "bfloat16")
    params = r_lm.init_params(rcfg, jax.random.key(2))
    model = interop.lm_params_from_numpy(cfg, _np(params), device="cpu")
    fresh = lm.LM(cfg, device="cpu")
    def f32(name):     # layers.<i>.<mixer>.<key>
        parts = name.split(".")
        return len(parts) == 4 and parts[3] in F32_PARAMS.get(parts[2], ())

    for m in (model, fresh):
        for name, p in m.named_parameters():
            assert p.dtype == (torch.float32 if f32(name) else torch.bfloat16), name
    for path, a in jax.tree_util.tree_leaves_with_path(params):
        name = ".".join(str(k.key) for k in path).replace("layers.", "layers.0.")
        assert a.dtype == (jnp.float32 if f32(name) else jnp.bfloat16), name
    for a, b in zip(jax.tree.leaves(interop.lm_params_to_numpy(cfg, model)),
                    jax.tree.leaves(_np(jax.tree.map(lambda v: v.astype(jnp.float32), params)))):
        np.testing.assert_array_equal(a, b)


def _impls(cfg):
    if cfg.family == "hybrid":
        return [dict(mamba_impl="scan"), dict(mamba_impl="assoc")]
    return [dict(mlstm_impl="scan"), dict(mlstm_impl="chunked", mlstm_chunk=16)]


@pytest.mark.parametrize("which", [0, 1])
def test_forward_logits_and_loss_match_under_both_impls(ssm_pair, which):
    rcfg, cfg, params, model, tokens, labels = ssm_pair
    impl = _impls(cfg)[which]
    rcfg, cfg = replace(rcfg, **impl), replace(cfg, **impl)
    want = jax.jit(lambda p, t: r_lm.forward_logits(rcfg, p, dict(tokens=t)))(params, tokens)
    got = lm.forward_logits(cfg, model, dict(tokens=torch.from_numpy(tokens)), use_kernel=True)
    assert got.shape == (2, 64, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    _, wm = jax.jit(lambda p, t, y: r_lm.forward_loss(rcfg, p, dict(tokens=t, labels=y)))(
        params, tokens, labels)
    gm = make_prefill_step(cfg, use_kernel=True)(
        model, dict(tokens=torch.from_numpy(tokens), labels=torch.from_numpy(labels)))
    assert set(gm) == set(wm) == {"loss", "nll"}
    for key in ("loss", "nll"):
        np.testing.assert_allclose(float(gm[key]), float(wm[key]), **F32_TOL, err_msg=key)
    assert abs(float(gm["nll"]) - np.log(cfg.vocab)) < 1.5


def test_the_impls_agree_with_each_other(ssm_pair):
    # the reference's own check (tests/test_ssm_impls.py), on the port
    rcfg, cfg, params, model, tokens, labels = ssm_pair
    batch = dict(tokens=torch.from_numpy(tokens), labels=torch.from_numpy(labels))
    a, b = (float(make_prefill_step(replace(cfg, **impl))(model, batch)["loss"])
            for impl in _impls(cfg))
    np.testing.assert_allclose(a, b, rtol=1e-5 if cfg.family == "hybrid" else 1e-4)


# (arch, config changes, decode length): hymba at its window 32, then at
# window 8, so that 20 positions wrap its ring cache twice
DECODE_CASES = [("hymba-1.5b", {}, 12), ("hymba-1.5b", dict(attn_window=8), 20),
                ("xlstm-1.3b", {}, 12)]


@pytest.mark.parametrize("arch,fix,s", DECODE_CASES)
def test_decode_matches_the_reference_and_prefill(arch, fix, s):
    rcfg, cfg = _cfgs(arch, **fix)
    params = _np(r_lm.init_params(rcfg, jax.random.key(1)))
    model = interop.lm_params_from_numpy(cfg, params, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, s)).astype(np.int32)
    prefill = lm.forward_logits(cfg, model, dict(tokens=torch.from_numpy(tokens)))
    rstep = jax.jit(lambda p, st, t: r_lm.decode_step(rcfg, p, st, t))
    rstate = r_lm.init_decode_state(rcfg, 2, s)
    step = make_serve_step(cfg)
    with torch.inference_mode():
        state = lm.init_decode_state(cfg, 2, s, device="cpu")
    if cfg.attn_window:
        assert state["cache"]["k"].shape[2] == min(cfg.attn_window, s)
    for t in range(s):
        want, rstate = rstep(params, rstate, jnp.asarray(tokens[:, t]))
        got, state = step(model, state, dict(tokens=torch.from_numpy(tokens[:, t])))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL, err_msg=f"{t}")
        np.testing.assert_allclose(got.numpy(), prefill[:, t].numpy(), **F32_TOL,
                                   err_msg=f"{t}")
    assert int(state["pos"]) == int(rstate["pos"]) == s
    # every carried state equals the reference's after the last step
    for path, a in jax.tree_util.tree_leaves_with_path(_np(rstate["cache"])):
        node = state["cache"]
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(_f32(node), a, **F32_TOL, err_msg=jax.tree_util.keystr(path))


def _requests(mk):
    return [mk(uid=0, prompt=[5, 9, 2], max_new_tokens=6),
            mk(uid=1, prompt=[7, 11, 13, 1, 4], max_new_tokens=4),
            mk(uid=2, prompt=[3], max_new_tokens=20),             # truncated by the cache
            mk(uid=3, prompt=[8, 8], max_new_tokens=5)]


@pytest.mark.parametrize("arch,fix,s", DECODE_CASES)
def test_serve_engine_token_ids_equal_the_reference(arch, fix, s):
    rcfg, cfg = _cfgs(arch, **fix)
    params = _np(r_lm.init_params(rcfg, jax.random.key(4)))
    model = interop.lm_params_from_numpy(cfg, params, device="cpu")
    reng = RServeEngine(rcfg, params, batch_slots=3, cache_len=16)
    eng = ServeEngine(cfg, model, batch_slots=3, cache_len=16, device="cpu")
    for r, t in zip(_requests(RRequest), _requests(Request)):
        reng.submit(r)
        eng.submit(t)
    want = {r.uid: (r.output, r.truncated) for r in reng.run_until_drained()}
    got = {r.uid: (r.output, r.truncated) for r in eng.run_until_drained()}
    assert got == want
    assert eng.steps_executed == reng.steps_executed


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_batch_equals_solo(arch):
    _, cfg = _cfgs(arch, attn_window=8) if arch == "hymba-1.5b" else _cfgs(arch)
    model = lm.LM(cfg, device="cpu")
    solo = ServeEngine(cfg, model, batch_slots=1, cache_len=32, device="cpu")
    solo.submit(Request(uid=0, prompt=[7, 11, 13], max_new_tokens=12))
    want = solo.run_until_drained()[0].output
    batched = ServeEngine(cfg, model, batch_slots=4, cache_len=32, device="cpu")
    for uid, p0 in enumerate([3, 7, 9, 21]):
        batched.submit(Request(uid=uid, prompt=[p0, 11, 13], max_new_tokens=12))
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
    if cfg.family == "ssm":
        # layer 0 runs its mLSTM, layer 1 its sLSTM: each other branch has zero
        # gradients in the reference and is only decayed, w (1 - lr·0.1)
        for name, layer in (("slstm", 0), ("mlstm", 1)):
            g = flat_g[(jax.tree_util.DictKey("layers"), jax.tree_util.DictKey(name),
                        jax.tree_util.DictKey("wo"))][layer]
            assert not g.any()
            before = params["layers"][name]["wo"][layer]
            after = _f32(getattr(model.layers[layer], name).wo)
            np.testing.assert_allclose(after, before * (1 - lr * 0.1), rtol=1e-6)
            assert not np.array_equal(after, before)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_microbatched_takes_unused_branches(arch):
    _, cfg = _cfgs(arch)
    batch = synthetic_batch(0, 0, 4, 16, cfg.vocab)
    runs = []
    for mb in (0, 2):
        model = lm.LM(cfg, device="cpu")
        _, m = make_train_step(cfg, microbatch=mb)(model, adamw_init(model), batch, 0)
        runs.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-5)


def _grads(cfg, model, batch):
    loss, _ = lm.forward_loss(cfg, model, batch)
    return torch.autograd.grad(loss, list(model.parameters()), allow_unused=True,
                               materialize_grads=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_equal_gradients(arch, monkeypatch):
    _, cfg = _cfgs(arch)
    model = lm.LM(cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(1, 0, 2, 32, cfg.vocab).items()}
    full = _grads(cfg, model, batch)
    save = _grads(replace(cfg, remat_policy="save_attn"), model, batch)
    monkeypatch.setattr(lm, "checkpoint", lambda fn, *a, **kw: fn(*a))   # no remat
    none = _grads(cfg, model, batch)
    names = [n for n, _ in model.named_parameters()]
    mixer = "mamba.a_log" if cfg.family == "hybrid" else "mlstm.wq"
    assert float(none[names.index(f"layers.0.{mixer}")].abs().max()) > 0
    for a, b, c in zip(full, save, none):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(b, c, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_reduces_loss(arch):
    # tests/test_archs.py::test_training_reduces_loss on the port
    _, cfg = _cfgs(arch)
    model = lm.LM(cfg, device="cpu")
    opt = adamw_init(model)
    step = make_train_step(cfg, base_lr=3e-3, total_steps=100, warmup_steps=5)
    batch = synthetic_batch(2, 0, 4, 16, cfg.vocab)
    losses = []
    for i in range(15):
        opt, m = step(model, opt, batch, i)
        losses.append(float(m["nll"]))
    assert losses[-1] < losses[0] * 0.8, losses


def test_param_count_and_model_flops_match_the_reference():
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), r_get_config(arch)
        assert cfg.param_count() == rcfg.param_count()
        for shape in SHAPES.values():
            assert model_flops(cfg, shape) == r_roofline.model_flops(rcfg, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_smoke_on_cpu(arch, capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", arch, "--smoke", "--batch", "2", "--tokens", "3",
                       "--device", "cpu"]) == 0
    assert "2 streams × 3 tokens" in capsys.readouterr().out


def test_unported_families_stay_vlm_and_audio():
    # the vlm and audio families are ported now: every family of the registry runs
    assert not hasattr(lm, "UNPORTED_FAMILIES")
    assert set(lm.PORTED_FAMILIES) == {"dense", "moe", "hybrid", "ssm", "vlm", "audio"}
    assert {get_smoke(a).family for a in list_archs()} <= set(lm.PORTED_FAMILIES)
