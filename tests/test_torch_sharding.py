"""The sharded training step of the PyTorch port against the JAX reference.

The reference's own sharded step cannot be the oracle (its embedding
gather raises under a mesh on jax 0.9.0, ``tests/test_distributed.py``),
so each check holds the port to what can be:

* the sharding rules, pure functions of shapes: ``param_specs``,
  ``batch_spec`` and ``cache_spec`` against the reference's on
  ``AbstractMesh`` (16, 16), (2, 16, 16) and (4, 2), every leaf of all ten
  archs, equal entry for entry (the port's per-layer leaf against the
  reference's stacked leaf without its stack dims);
* the function, which sharding does not change: the port's step on a
  (4, 2) and an (8, 1) gloo mesh against ``jax.jit(make_train_step)`` of
  the reference, unsharded, on the same weights and batches (loss, nll,
  grad_norm and the MoE's load_balance rtol 1e-4; gathered parameters
  within the reference's resume tolerance, atol 1e-5 rtol 1e-4, except
  elements whose gradient is below 1e-6, held to twice the summed learning
  rates, as ``tests/test_torch_train.py`` holds the unsharded step); the
  MoE's routing over the global batch (deepseek-moe-smoke on (8, 1) at a
  capacity factor that drops slots, whole and in two microbatches);
* decode on a mesh against ``jax.jit(make_serve_step)`` of the reference,
  unsharded, on the same weights and tokens: heads split over ``model``,
  the positions split over ``model``, and over ``data`` at batch 1; the
  moe and ssm families' rows over ``data`` (argmax ids equal, logits and
  every state leaf gathered whole within DECODE_TOL); the
  decode state's placements against the reference's
  ``_decode_state_shardings`` for every dense arch's ``decode_32k`` on the
  production meshes;
* the compressor: ``compress_int8``/``decompress_int8`` bit-equal;
  ``compressed_psum`` over 8 gloo ranks in the reference's quadratic loop
  (``test_distributed.py::test_grad_compression_dp_loop_8dev``) converges
  within 2e-2 and ends within 1e-5 of the reference's weights (the sums'
  order differs; the reference runs its ``compressed_psum`` under
  ``jax.vmap`` over a named axis of 8, the same ``psum``, which agreed with
  its 8-host-device shard_map run to 7.5e-9: that form times out under
  load, ROADMAP C);
* checkpoints both ways between one device and the mesh, and the
  production-mesh dry run on a fake process group.

Every gloo world meets through a file store: no socket, no port.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import get_config as r_get_config
from repro.configs import get_smoke as r_get_smoke
from repro.configs import list_archs
from repro.models import lm as r_lm
from repro.models import sharding as r_sharding
from repro.models.steps import abstract_decode_state, abstract_opt_state, abstract_params
from repro.models.steps import make_serve_step as r_make_serve_step
from repro.models.steps import make_train_step as r_make_train_step
from repro.optim import adamw_init as r_adamw_init
from repro.optim import compress as r_compress
from repro.roofline import collective_bytes_from_hlo
from repro.train import TrainConfig as RTrainConfig
from repro.train import TrainLoop as RTrainLoop

import torch_mesh_workers as workers
from repro_torch import interop
from repro_torch.configs import SHAPES, get_config, get_smoke
from repro_torch.data import synthetic_batch
from repro_torch.models import lm
from repro_torch.models.sharding import (EP_ONLY_EXPERT_RULES, MeshCtx, batch_spec, cache_spec,
                                         decode_state_specs, param_specs, reference_path,
                                         to_placements)
from repro_torch.models.steps import make_serve_step
from repro_torch.optim import compress_int8, decompress_int8
from repro_torch.roofline import collective_bytes, parse_shape_bytes
from repro_torch.train import TrainConfig, TrainLoop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model"))]
STEP_TOL = dict(atol=1e-5, rtol=1e-4)


def _ctxs(shape, names):
    return (r_sharding.MeshCtx(AbstractMesh(shape, names)),
            MeshCtx(dict(zip(names, shape))))


def _flat(tree, is_leaf=None) -> dict:
    return {jax.tree_util.keystr(path, simple=True, separator="/"): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


# ---------------------------------------------------------------- rules


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_the_reference(arch):
    """Every parameter's (and AdamW moment's) spec on all three meshes,
    with and without EP_ONLY_EXPERT_RULES."""
    cfg = get_config(arch)
    shapes = {k: tuple(p.shape) for k, p in lm.LM(cfg, device="meta").named_parameters()}
    p_abs, o_abs = abstract_params(r_get_config(arch)), abstract_opt_state(r_get_config(arch))
    leaves = _flat(p_abs)
    for mesh in MESHES:
        rctx, ctx = _ctxs(*mesh)
        for rules, r_rules in ((None, None), (EP_ONLY_EXPERT_RULES,
                                              r_sharding.EP_ONLY_EXPERT_RULES)):
            want = _flat(r_sharding.param_specs(rctx, p_abs, r_rules),
                         is_leaf=lambda x: isinstance(x, PartitionSpec))
            got = param_specs(ctx, cfg, shapes, rules)
            assert len(got) == len(shapes)
            used = set()
            for name, spec in got.items():
                path, stack = reference_path(cfg, name)
                used.add(path)
                assert tuple(leaves[path].shape) == stack + shapes[name], name
                assert spec == tuple(want[path])[len(stack):], (mesh, name, spec, want[path])
            assert used == set(want)
            # the moments take their parameters' specs (mu/..., nu/...)
            o_want = _flat(r_sharding.param_specs(rctx, o_abs, r_rules),
                           is_leaf=lambda x: isinstance(x, PartitionSpec))
            for name in list(shapes)[:40]:
                spec = param_specs(ctx, cfg, {f"mu.{name}": shapes[name]}, rules)[f"mu.{name}"]
                path, stack = reference_path(cfg, f"mu.{name}")
                assert spec == tuple(o_want[path])[len(stack):], name


BATCH_SHAPES = [(256, 4096), (32, 32768), (16, 4096), (8, 64), (3, 100), (1, 524288),
                (128,), (256, 1601, 4096), (2, 1500, 512)]
CACHE_SHAPES = [((40, 128, 32768, 8, 128), 2), ((40, 1, 524288, 8, 128), 2),
                ((32, 4, 1024, 5, 64), 2), ((64, 2, 4096, 40, 128), 2),
                ((40, 16, 512, 32, 128), 2), ((48, 1, 4, 512, 512), None),
                ((32, 8, 1600, 16), None), ((48, 128, 4, 512), None)]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
def test_batch_and_cache_specs_equal_the_reference(mesh):
    """Batches over (pod, data), the small-batch fallback to data and to
    replication; caches by batch, by sequence, heads over tp or not."""
    rctx, ctx = _ctxs(*mesh)
    for shape in BATCH_SHAPES:
        assert batch_spec(ctx, shape) == tuple(r_sharding.batch_spec(rctx, shape)), shape
    seen = set()
    for shape, seq_axis in CACHE_SHAPES:
        got = cache_spec(ctx, shape, seq_axis=seq_axis)
        assert got == tuple(r_sharding.cache_spec(rctx, shape, seq_axis=seq_axis)), shape
        seen.add(got[1] is None and seq_axis is not None and got[seq_axis] is not None)
    assert True in seen          # some cache shards its sequence, not its batch


def test_to_placements_say_what_the_spec_says():
    from torch.distributed.tensor import Replicate, Shard

    names = ("pod", "data", "model")
    assert to_placements((None, "data", "model"), names) == [Replicate(), Shard(1), Shard(2)]
    assert to_placements((("pod", "data"), None), names) == [Shard(0), Shard(0), Replicate()]
    assert to_placements(("model", None), ("data", "model")) == [Replicate(), Shard(0)]
    assert to_placements((), ("data",)) == [Replicate()]


def test_constrain_leaves_a_plain_tensor_alone():
    from repro_torch.models.sharding import constrain

    x = torch.arange(8.0).reshape(2, 4)
    assert constrain(x, ("dp", None)) is x
    assert constrain(x, ("dp", None), MeshCtx(dict(data=2, model=2))) is x


# ---------------------------------------------------------------- compression


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_int8_is_bit_equal(dtype):
    rng = np.random.default_rng(4)
    cases = [rng.standard_normal(1000).astype(np.float32) * 3.0,
             rng.standard_normal((17, 33)).astype(np.float32) * 1e-3,
             # g / scale lands on halves: rounding half to even in both
             np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 126.5, -126.5, 3.5], np.float32),
             np.zeros(5, np.float32)]
    for g in cases:
        jg = jnp.asarray(g, dtype=dtype)
        tg = torch.from_numpy(g).to(getattr(torch, dtype))
        jq, js = r_compress.compress_int8(jg)
        tq, ts = compress_int8(tg)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
        np.testing.assert_array_equal(decompress_int8(tq, ts).numpy(),
                                      np.asarray(r_compress.decompress_int8(jq, js)))


def test_compressed_psum_dp_loop_matches_the_reference(mesh_runs):
    """``compressed_psum`` over 8 gloo ranks in the reference's loop."""
    steps, lr = COMPRESS
    w_true = np.asarray(jnp.asarray(np.random.default_rng(0).standard_normal(16)))
    x = np.random.default_rng(1).standard_normal((8, 1, 64, 16)).astype(np.float32)

    def local_grad(w, xs):
        err = xs @ (w - w_true)
        return 2 * xs.T @ err / xs.shape[0]

    def step(_, carry):
        w, r = carry

        def one(xs):
            g, rr = r_compress.compressed_psum(dict(w=local_grad(w, xs[0])), dict(w=r), "data")
            return g["w"], rr["w"]
        g, rr = jax.vmap(one, axis_name="data")(jnp.asarray(x))
        return w - lr * g[0], rr[0]     # out_specs=P(): one replicated value, shard 0's

    w, _ = jax.jit(lambda c: jax.lax.fori_loop(0, steps, step, c))((jnp.zeros(16),
                                                                     jnp.zeros(16)))
    got = np.load(mesh_runs["folder"] / "compress" / "w.npy")
    assert float(np.abs(got - w_true).max()) < 2e-2
    np.testing.assert_allclose(got, np.asarray(w), rtol=0, atol=1e-5)


# ---------------------------------------------------------------- roofline


def test_collective_bytes_equal_the_reference():
    """The collectives of tests/test_roofline.py's HLO as records."""
    hlo = """
  %all-gather.1 = bf16[16,1024]{1,0} all-gather(%p0), dimensions={0}
  %x = f32[4]{0} add(%a, %b)
  ROOT %all-reduce.2 = f32[256,256]{1,0} all-reduce(%x2), to_apply=%sum
  %rs = f32[8,8]{1,0} reduce-scatter(%y), dimensions={0}
  %ag2 = (bf16[2,2]{1,0}, bf16[2,2]{1,0}) all-gather-start(%z), dimensions={0}
"""
    records = [dict(collective="all-gather", bytes=parse_shape_bytes("bf16[16,1024]")),
               dict(op="aten.add", bytes=parse_shape_bytes("f32[4]")),
               dict(collective="all-reduce", bytes=parse_shape_bytes("f32[256,256]")),
               dict(collective="reduce-scatter", bytes=parse_shape_bytes("f32[8,8]")),
               dict(collective="all-gather",
                    bytes=parse_shape_bytes("(bf16[2,2]{1,0}, bf16[2,2]{1,0})"))]
    assert collective_bytes(records) == collective_bytes_from_hlo(hlo)


# ---------------------------------------------------------------- the step


# every run on a mesh below shares one start of 8 gloo ranks (a rank takes
# seconds to import torch and the port): the module's fixture prepares the
# reference's side, runs the ranks once, and each test reads its part
STEPS = dict(steps=2, batch=8, seq=32, kw=dict(base_lr=1e-3, total_steps=10, warmup_steps=1))
#: case → (arch, mesh, microbatches: 0 for the whole batch at once, config changes, global
#: batch).  The MoE's capacity factor 1.0 makes the routing of 8 rows drop slots (its
#: capacity round(256·2/8) = 64 a expert), where each rank's 32 tokens alone would give 8;
#: in two microbatches of 8 rows, each routes over the reference's rows [8i, 8i + 8), a row
#: a rank
STEP_CASES = {"qwen2.5-smoke-4x2": ("qwen2.5-32b", (4, 2), 0, {}, 8),
              "qwen2.5-smoke-4x2-microbatch2": ("qwen2.5-32b", (4, 2), 2, {}, 8),
              "hymba-smoke-8x1": ("hymba-1.5b", (8, 1), 0, {}, 8),
              "deepseek-moe-smoke-8x1": ("deepseek-moe-16b", (8, 1), 0,
                                         dict(capacity_factor=1.0), 8),
              "deepseek-moe-smoke-8x1-microbatch2": ("deepseek-moe-16b", (8, 1), 2,
                                                     dict(capacity_factor=1.0), 16)}
#: decode case → (arch, mesh, batch, (a state leaf, its dim, the mesh axis that splits it));
#: each runs DECODE["steps"] steps into a DECODE["seq"]-slot cache, so that the positions
#: reach several ranks' slices where they are split
DECODE_CASES = {
    # the KV heads over model
    "qwen1.5-smoke-4x2": ("qwen1.5-32b", (4, 2), 4, ("k", 3, "model")),
    # the positions over model (KV heads 2 do not divide 4)
    "qwen2.5-smoke-2x4": ("qwen2.5-32b", (2, 4), 4, ("k", 2, "model")),
    # the positions over data (batch 1)
    "granite-smoke-8x1-batch1": ("granite-3-8b", (8, 1), 1, ("k", 2, "data")),
    # the rows over data; the MoE routes the 8 rows together
    "deepseek-moe-smoke-8x1-batch8": ("deepseek-moe-16b", (8, 1), 8, ("k", 1, "data")),
    # the rows over data; the (L, B, H) states whole on every rank, their rows shared back
    "xlstm-smoke-8x1-batch8": ("xlstm-1.3b", (8, 1), 8, ("mlstm/c", 1, "data")),
}
DECODE = dict(seq=16, steps=8)
#: float32 on the CPU: the sharded decode against the reference's, logits and caches (the
#: log-sum-exp combine and the partial sums' order move the last bits: ~4e-6 seen)
DECODE_TOL = dict(atol=1e-5, rtol=1e-4)
#: a case's own tolerance where DECODE_TOL is not it: xlstm's recurrences amplify float32
#: rounding (the port's unsharded decode of these 8 rows as one batch and of each row alone,
#: which is what a rank of the (8, 1) mesh does, differ by 1.2e-4 at step 3; the port and
#: the reference by 1.5e-4), so it is held to tests/test_torch_ssm.py's F32_TOL, the
#: tolerance of its unsharded decode against the reference
DECODE_CASE_TOL = {"xlstm-smoke-8x1-batch8": dict(atol=2e-4, rtol=1e-3)}
COMPRESS = (200, 0.05)
ARCH = "granite-3-8b"
LAUNCH = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "4", "--seq", "16", "--device",
          "cpu", "--ckpt-every", "1"]


def _tc(cls, folder, **kw):
    base = dict(steps=4, batch=4, seq=16, ckpt_dir=str(folder), ckpt_every=2, base_lr=1e-3,
                warmup_steps=2, log_every=1)
    base.update(kw)
    return cls(**base)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The reference's runs, then every mesh run on 8 spawned gloo ranks:
    the two sharded steps, the compressed loop, a TrainLoop resuming the
    reference's one-device checkpoint on a (4, 2) mesh, a TrainLoop on a
    (4, 2) mesh writing checkpoints, and ``launch.train --mesh``."""
    import shutil

    folder = tmp_path_factory.mktemp("mesh_runs")
    refs, plan = {}, []
    for case, (arch, shape, microbatch, changes, batch) in STEP_CASES.items():
        (folder / case).mkdir()
        rcfg = replace(r_get_smoke(arch), dtype="float32", **changes)
        kw = dict(STEPS["kw"], microbatch=microbatch)
        refs[case] = _reference_run(rcfg, batch, STEPS["seq"], STEPS["steps"], kw)
        workers.save_tree(str(folder / case / "params.npz"), refs[case][0])
        plan.append(("step_on_mesh", (shape, arch, changes, str(folder / case), STEPS["steps"],
                                      batch, STEPS["seq"], kw)))
    for case, (arch, shape, batch, _) in DECODE_CASES.items():
        (folder / case).mkdir()
        refs[case] = _reference_decode(arch, shape, batch, folder / case)
        plan.append(("decode_on_mesh", (shape, arch, batch, DECODE["seq"], str(folder / case))))
    plan.append(("decode_refusals", (str(folder),)))
    (folder / "compress").mkdir()
    np.savez(folder / "compress" / "data.npz",
             x=np.random.default_rng(1).standard_normal((8, 1, 64, 16)).astype(np.float32),
             w_true=np.asarray(jnp.asarray(np.random.default_rng(0).standard_normal(16))))
    plan.append(("compress_loop", (str(folder / "compress"), *COMPRESS)))
    RTrainLoop(replace(r_get_smoke(ARCH), dtype="float32"),
               _tc(RTrainConfig, folder / "one_cut", steps=2)).run()
    shutil.copytree(folder / "one_cut", folder / "one_alone")
    (folder / "restore").mkdir()
    plan.append(("loop_on_mesh", ((4, 2), ARCH, vars(_tc(TrainConfig, folder / "one_cut")),
                                  str(folder / "restore"))))
    (folder / "write").mkdir()
    plan.append(("loop_on_mesh", ((4, 2), ARCH,
                                  vars(_tc(TrainConfig, folder / "mesh_cut", steps=2)),
                                  str(folder / "write"))))
    # last: launch.train ends the process group
    plan.append(("launch_train", (LAUNCH + ["--ckpt-dir", str(folder / "launch"), "--mesh",
                                            "data=4,model=2"],)))
    workers.spawn(workers.run_all, 8, plan)
    return dict(folder=folder, refs=refs)


def _reference_run(rcfg, batch, seq, steps, kw):
    """The reference's unsharded jitted step from init_params(key(0)):
    (initial numpy tree, final tree, metrics per step, tiny-gradient masks,
    summed learning rate)."""
    params = jax.tree.map(np.asarray, r_lm.init_params(rcfg, jax.random.key(0)))
    jp, jopt = params, r_adamw_init(params)
    rstep = jax.jit(r_make_train_step(rcfg, **kw))
    rgrad = jax.jit(jax.grad(lambda p, b: r_lm.forward_loss(rcfg, p, b)[0]))
    tiny, lr_sum, metrics = None, 0.0, []
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in synthetic_batch(0, i, batch, seq, rcfg.vocab).items()}
        small = jax.tree.map(lambda g: (np.abs(np.asarray(g)) < 1e-6) & (np.asarray(g) != 0),
                             rgrad(jp, b))
        tiny = small if tiny is None else jax.tree.map(np.logical_or, tiny, small)
        jp, jopt, m = rstep(jp, jopt, b, jnp.int32(i))
        lr_sum += float(m["lr"])
        metrics.append({k: float(v) for k, v in m.items()})
    return params, jax.tree.map(np.asarray, jp), jopt, metrics, tiny, lr_sum


def _reference_decode(arch, mesh, batch, folder):
    """The reference's unsharded jitted serve step from init_params(key(0))
    over seeded tokens: the weights and tokens saved for the ranks, each
    step's logits, the final state's leaves by path ("k", "mlstm/c", ...)
    and their specs on the case's mesh as the reference's dry run places
    them (``_decode_state_shardings``) returned."""
    from repro.launch.dryrun import _decode_state_shardings

    rcfg = replace(r_get_smoke(arch), dtype="float32")
    params = jax.tree.map(np.asarray, r_lm.init_params(rcfg, jax.random.key(0)))
    workers.save_tree(str(folder / "params.npz"), params)
    tokens = np.random.default_rng(5).integers(0, rcfg.vocab, (DECODE["steps"], batch),
                                               dtype=np.int32)
    np.save(folder / "tokens.npy", tokens)
    step = jax.jit(r_make_serve_step(rcfg))
    state = r_lm.init_decode_state(rcfg, batch, DECODE["seq"])
    logits = []
    for t in tokens:
        out, state = step(params, state, dict(tokens=jnp.asarray(t)))
        logits.append(np.asarray(out))
    rctx = r_sharding.MeshCtx(AbstractMesh(mesh, ("data", "model")))
    specs = _flat(_decode_state_shardings(rctx, state)["cache"],
                  is_leaf=lambda x: hasattr(x, "spec"))
    return dict(logits=np.stack(logits), cache=_flat(jax.tree.map(np.asarray, state["cache"])),
                specs={k: tuple(v.spec) for k, v in specs.items()})


def _assert_tree_close(got: dict, want: dict, tiny=None, lr_sum=0.0):
    g, w = _flat(got), _flat(want)
    t = _flat(tiny) if tiny is not None else {}
    assert set(g) == set(w)
    for path, a in g.items():
        b = np.asarray(w[path], np.float32)
        limit = STEP_TOL["atol"] + STEP_TOL["rtol"] * np.abs(b)
        if path in t:
            limit = np.where(t[path], 2 * lr_sum, limit)
        bad = np.abs(a - b) > limit
        assert not bad.any(), (path, int(bad.sum()), float(np.abs(a - b).max()))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sharded_step_matches_the_reference(case, mesh_runs):
    """Two steps on the mesh against the reference's unsharded jitted step:
    the dense family with tensor parallelism (the vocab-parallel embedding
    and loss, local heads) and FSDP, whole and in two microbatches (each
    the reference's slice of four rows, a row a data rank, their reduced
    gradients summed in float32); the hybrid family with FSDP alone; the
    moe family routing over the global batch, whole and in two
    microbatches (each routing over the reference's rows of it)."""
    folder = mesh_runs["folder"] / case
    _, want, jopt, metrics, tiny, lr_sum = mesh_runs["refs"][case]
    with open(folder / "got.json") as f:
        got = json.load(f)
    assert got["wrong"] == []                 # every placement is the spec's
    for mine, ref in zip(got["history"], metrics):
        for key in ("loss", "nll", "grad_norm", "load_balance"):
            if key in ref:
                np.testing.assert_allclose(mine[key], ref[key], rtol=1e-4, err_msg=key)
        np.testing.assert_allclose(mine["lr"], ref["lr"], rtol=1e-6)
    if r_get_smoke(STEP_CASES[case][0]).n_experts:
        # the routing over the global batch dropped slots (the reference's does the same:
        # the loss, its load_balance and the parameters above agree)
        assert sum(got["drops"]) > 0
    _assert_tree_close(workers.load_tree(str(folder / "got.npz")), want, tiny, lr_sum)
    assert got["count"] == int(jopt["count"]) == STEPS["steps"]
    for a, b in zip(jax.tree.leaves(workers.load_tree(str(folder / "mu.npz"))),
                    jax.tree.leaves(jax.tree.map(np.asarray, jopt["mu"]))):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-7)
    if STEP_CASES[case][1][1] > 1:
        assert got["refused"] is not None and "ROADMAP A2" in got["refused"]


# ---------------------------------------------------------------- decode


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_sharded_decode_matches_the_reference(case, mesh_runs):
    """DECODE["steps"] decode steps on the mesh against the reference's
    unsharded jitted serve step: every state leaf placed as the
    reference's dry run places it (the case's leaf split as it says),
    argmax ids equal, logits and every leaf gathered whole within the
    case's tolerance (DECODE_TOL unless DECODE_CASE_TOL says otherwise),
    a KV cache's slots past the last position still zero; and the same
    against the port's unsharded decode of the same weights."""
    arch, shape, batch, (leaf, dim, axis) = DECODE_CASES[case]
    folder = mesh_runs["folder"] / case
    want = mesh_runs["refs"][case]
    with open(folder / "got.json") as f:
        meta = json.load(f)
    got = np.load(folder / "got.npz")
    ctx = MeshCtx(dict(data=shape[0], model=shape[1]))
    assert set(meta["placements"]) == set(want["specs"]) == set(want["cache"])
    for path, spec in want["specs"].items():
        assert meta["placements"][path] == [str(p) for p in to_placements(spec, ("data", "model"))
                                            ], (path, spec)
    assert want["specs"][leaf][dim] == axis, want["specs"][leaf]
    assert meta["local"][leaf][dim] == want["cache"][leaf].shape[dim] // ctx.size(axis)
    assert meta["pos"] == DECODE["steps"]
    tol = DECODE_CASE_TOL.get(case, DECODE_TOL)
    np.testing.assert_array_equal(got["logits"].argmax(-1), want["logits"].argmax(-1))
    np.testing.assert_allclose(got["logits"], want["logits"], **tol)
    for path, w in want["cache"].items():
        np.testing.assert_allclose(got[path], w, err_msg=path, **tol)
        if path in ("k", "v"):
            assert not got[path][:, :, DECODE["steps"]:].any()
    cfg = replace(get_smoke(arch), dtype="float32")
    model = interop.lm_params_from_numpy(cfg, workers.load_tree(str(folder / "params.npz")),
                                         device="cpu")
    state = lm.init_decode_state(cfg, batch, DECODE["seq"], device="cpu")
    step = make_serve_step(cfg)
    for i, t in enumerate(np.load(folder / "tokens.npy")):
        out, state = step(model, state, dict(tokens=torch.from_numpy(t)))
        np.testing.assert_allclose(got["logits"][i], out.numpy(), err_msg=f"step {i}", **tol)
    for path, leaf in _flat(state["cache"]).items():
        np.testing.assert_allclose(got[path], leaf.numpy(), err_msg=path, **tol)


def test_decode_refuses_what_it_cannot_place(mesh_runs):
    """A sliding-window ring whose positions the rules split over ranks
    (hymba-smoke at batch 1 on (8, 1)), the moe family at model > 1 and
    the vlm family on a mesh raise ``NotImplementedError`` naming ROADMAP
    A2, before any cache is made or gathered."""
    with open(mesh_runs["folder"] / "refusals.json") as f:
        got = json.load(f)
    for what in ("ring", "moe", "vlm"):
        assert got[what] is not None and "ROADMAP A2" in got[what], (what, got[what])


@pytest.mark.parametrize("mesh", MESHES[:2], ids=lambda m: "x".join(map(str, m[0])))
def test_decode_state_specs_equal_the_reference(mesh):
    """Every leaf of every dense arch's decode_32k state placed as the
    reference's dry run places it (``_decode_state_shardings``), from
    abstract shapes: the port's tree of ``init_decode_state`` (made on meta)
    against the reference's ``abstract_decode_state``."""
    from repro.launch.dryrun import _decode_state_shardings

    rctx, ctx = _ctxs(*mesh)
    shape = SHAPES["decode_32k"]
    for arch in list_archs():
        cfg = get_config(arch)
        if cfg.family != "dense":
            continue
        want = _flat(_decode_state_shardings(rctx, abstract_decode_state(r_get_config(arch),
                                                                         shape)),
                     is_leaf=lambda x: hasattr(x, "spec"))
        state = lm.decode_state_shapes(cfg, shape.global_batch, shape.seq_len)
        got = _flat(decode_state_specs(ctx, state), is_leaf=lambda x: isinstance(x, tuple))
        assert set(got) == set(want), arch
        for path, spec in got.items():
            assert spec == tuple(want[path].spec), (arch, path, spec, want[path].spec)
        # no dense arch's KV heads divide model = 16: the positions take it
        assert got["cache/k"][2] is not None and got["cache/k"][3] is None, got["cache/k"]


# ---------------------------------------------------------------- elastic restore


def _final(out, cfg):
    from repro_torch import interop

    if "model" in out:
        return interop.lm_params_to_numpy(cfg, out["model"])
    return jax.tree.map(lambda a: np.asarray(a, np.float32), out["params"])


def test_one_device_checkpoint_resumes_on_the_mesh(mesh_runs):
    """The reference's TrainLoop on one device wrote a checkpoint at step
    1; the port's TrainLoop on a (4, 2) mesh resumed it (elastic: placed
    shard by shard) and ends where the port's one-device TrainLoop resumed
    from the same checkpoint ends."""
    folder = mesh_runs["folder"]
    cfg = replace(get_smoke(ARCH), dtype="float32")
    with open(folder / "restore" / "steps.json") as f:
        assert json.load(f) == [2, 3]
    one = TrainLoop(cfg, _tc(TrainConfig, folder / "one_alone"), device="cpu").run()
    assert [m["step"] for m in one["history"]] == [2, 3]
    _assert_tree_close(workers.load_tree(str(folder / "restore" / "final.npz")),
                       _final(one, cfg))


def test_mesh_checkpoint_resumes_in_the_reference(mesh_runs, tmp_path):
    """The port's TrainLoop on a (4, 2) mesh wrote its checkpoints from
    rank 0, whole, in the reference's layout; the reference's TrainLoop
    resumes one and ends where the port's uninterrupted one-device run
    ends."""
    folder = mesh_runs["folder"]
    cfg = replace(get_smoke(ARCH), dtype="float32")
    rcfg = replace(r_get_smoke(ARCH), dtype="float32")
    assert sorted(os.listdir(folder / "mesh_cut")) == ["LATEST", "step_00000000.npz",
                                                       "step_00000001.npz"]
    full = TrainLoop(cfg, _tc(TrainConfig, tmp_path / "full"), device="cpu").run()
    resumed = RTrainLoop(rcfg, _tc(RTrainConfig, folder / "mesh_cut")).run()
    assert [m["step"] for m in resumed["history"]] == [2, 3]
    _assert_tree_close(_final(resumed, cfg), _final(full, cfg))


def test_launch_train_with_a_mesh(mesh_runs):
    """``launch.train --mesh data=4,model=2`` on 8 ranks wrote a checkpoint
    a step; the same command on one device resumes the last."""
    from repro_torch.launch import train

    ckpt = mesh_runs["folder"] / "launch"
    assert sorted(os.listdir(ckpt))[-1] == "step_00000002.npz"
    argv = LAUNCH + ["--ckpt-dir", str(ckpt)]
    argv[argv.index("--steps") + 1] = "4"
    assert train.main(argv) == 0
    assert sorted(os.listdir(ckpt))[-1] == "step_00000003.npz"


# ---------------------------------------------------------------- dry run


def test_dryrun_on_a_fake_world(tmp_path):
    """The reference test's assertions (temp bytes > 0, collectives > 0),
    which its own dry run fails, on a smoke arch over a (4, 2) fake world;
    granite-3-8b's train_4k cut to 1 layer on both production meshes (in
    one child process: the fake process group is the process's default
    one, and the dry run must load neither jax nor XLA_FLAGS); a smoke
    arch's decode cell on the (4, 2) world, its per-device cache bytes
    those of the reference's cache specs; then the moe family's train and
    decode cells skipped with their reasons."""
    from repro_torch.launch.dryrun import dryrun_cell

    code = """if True:
        import json, os, sys
        from dataclasses import asdict
        from repro_torch.configs import get_smoke
        from repro_torch.launch.dryrun import dryrun_cell
        smoke = {k: v for k, v in asdict(get_smoke("qwen2.5-32b")).items() if k != "name"}
        out = [dryrun_cell("qwen2.5-32b", "train_4k", mesh=dict(data=4, model=2), global_batch=8,
                           seq_len=64, overrides=smoke, verbose=False)]
        out += [dryrun_cell("granite-3-8b", "train_4k", multi_pod=mp, overrides=dict(n_layers=1),
                            verbose=False) for mp in (False, True)]
        out.append(dryrun_cell("qwen2.5-32b", "decode_32k", mesh=dict(data=4, model=2),
                               global_batch=8, seq_len=64, overrides=smoke, verbose=False))
        assert "jax" not in sys.modules and "XLA_FLAGS" not in os.environ
        print(json.dumps(out))
    """
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    smoke, *granite, decode = json.loads(r.stdout.strip().splitlines()[-1])
    assert smoke["status"] == "ok" and smoke["chips"] == 8, smoke
    assert smoke["memory"]["temp_bytes"] > 0 and smoke["collectives"]["total"] > 0
    assert set(smoke["collectives"]["per_kind"]) == {"all-gather", "all-reduce", "reduce-scatter"}
    for d, (mesh, chips) in zip(granite, (("16x16", 256), ("2x16x16", 512))):
        assert d["status"] == "ok" and d["mesh"] == mesh and d["chips"] == chips, d
        assert d["memory"]["param_bytes"] > 0 and d["roofline"]["hlo_flops_per_chip"] > 0
        assert d["roofline"]["dominant"] in ("compute", "memory", "collective")
        assert 0 < d["useful_flops_ratio"] < 1
    assert decode["status"] == "ok" and decode["chips"] == 8, decode
    rcfg = r_get_smoke("qwen2.5-32b")
    rctx = r_sharding.MeshCtx(AbstractMesh((4, 2), ("data", "model")))
    kv = (rcfg.n_layers, 8, 64, rcfg.n_kv_heads, rcfg.d_head)
    spec = r_sharding.cache_spec(rctx, kv, seq_axis=2)
    shards = np.prod([rctx.mesh.shape[a] for a in spec if a is not None])
    itemsize = np.dtype(jnp.dtype(rcfg.dtype)).itemsize
    assert decode["memory"]["cache_bytes"] == 2 * np.prod(kv) * itemsize // shards
    assert decode["memory"]["param_bytes"] > 0 and decode["collectives"]["total"] > 0
    for arch, shape in (("deepseek-moe-16b", "decode_32k"), ("deepseek-moe-16b", "train_4k")):
        d = dryrun_cell(arch, shape, verbose=False)
        assert d["status"] == "skipped" and "ROADMAP A2" in d["reason"], d
