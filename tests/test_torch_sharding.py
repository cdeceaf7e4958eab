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
  every state leaf gathered whole within DECODE_TOL); the moe family
  with its experts split over ``model`` (deepseek-moe-smoke on (2, 4),
  qwen3-moe-smoke on (4, 2)), in ``"auto"`` and in ``"manual"``, whose
  oracle is the reference's unsharded step on each data rank's rows; the
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
* ``moe_ffn`` on (4, 2) and (2, 4) gloo meshes in the reference's six
  dispatch modes against the reference's own ``moe_ffn`` under the same
  mesh (8 forced host devices, ``AxisType.Auto`` axes: under jax 0.9.0's
  default ``Explicit`` axes its ``constrain`` raises), and the sharded
  prefill's metrics against the reference's ``forward_loss``;
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
    # the rows over data, the heads and the experts' hidden f over model; global routing
    "deepseek-moe-smoke-2x4-batch8": ("deepseek-moe-16b", (2, 4), 8, ("k", 3, "model")),
    "qwen3-moe-smoke-4x2-batch8": ("qwen3-moe-235b-a22b", (4, 2), 8, ("k", 3, "model")),
    # "manual": each data rank routes its own 2 rows, 4 of the 8 experts a model rank
    "deepseek-moe-smoke-4x2-batch8-manual": ("deepseek-moe-16b", (4, 2), 8, ("k", 1, "data"),
                                             dict(moe_dispatch_sharding="manual")),
    "qwen3-moe-smoke-4x2-batch8-manual": ("qwen3-moe-235b-a22b", (4, 2), 8, ("k", 3, "model"),
                                          dict(moe_dispatch_sharding="manual")),
}
DECODE = dict(seq=16, steps=8)
#: sharded prefill case → (arch, mesh, config changes); the metrics of synthetic_batch(0, 0,
#: PREFILL["batch"], PREFILL["seq"]) against the reference's forward_loss (each data rank's
#: rows alone, averaged, under "manual")
PREFILL_CASES = {
    "deepseek-moe-smoke-2x4": ("deepseek-moe-16b", (2, 4), {}),
    "deepseek-moe-smoke-4x2-ep": ("deepseek-moe-16b", (4, 2), dict(moe_dispatch_sharding="ep")),
    "qwen3-moe-smoke-4x2-manual": ("qwen3-moe-235b-a22b", (4, 2),
                                   dict(moe_dispatch_sharding="manual")),
}
PREFILL = dict(batch=8, seq=32)
#: moe_ffn case → (mesh, dispatch mode, x); d 64, E 8, K 2, one shared expert, capacity
#: factor 1.0, which drops slots; x8 (8, 16, 64) splits over the data ranks, x2 (2, 16, 64)
#: does not (batch_spec leaves it whole: "manual" slices the tokens, "grouped" forms 4 groups)
MOE_MODES = ("auto", "ep", "grouped", "manual", "tokens_dp", "auto_ep")
MOE_FFN_CASES = {f"{mode}-{m[0]}x{m[1]}": (m, mode, "x8") for m in ((4, 2), (2, 4))
                 for mode in MOE_MODES}
MOE_FFN_CASES.update({f"{mode}-4x2-batch2": ((4, 2), mode, "x2") for mode in ("grouped", "manual")})
MOE_FFN = dict(d=64, e=8, f=64, k=2, cf=1.0)
#: moe_ffn on a mesh against the reference's under the same mesh (float32: the partial
#: sums' order and the all-reduce move the last bits, ~1.4e-6 seen)
MOE_FFN_TOL = dict(atol=1e-5, rtol=1e-4)
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
    for case, (arch, shape, batch, _, *changes) in DECODE_CASES.items():
        (folder / case).mkdir()
        changes = changes[0] if changes else {}
        refs[case] = _reference_decode(arch, shape, batch, folder / case, changes)
        plan.append(("decode_on_mesh", (shape, arch, batch, DECODE["seq"], str(folder / case),
                                        changes)))
    for case, (arch, shape, changes) in PREFILL_CASES.items():
        (folder / case).mkdir()
        refs[case] = _reference_prefill(arch, shape, changes, folder / case)
        plan.append(("prefill_on_mesh", (shape, arch, changes, str(folder / case),
                                         PREFILL["batch"], PREFILL["seq"])))
    (folder / "moe_ffn").mkdir()
    refs["moe_ffn"] = _reference_moe_ffn(folder / "moe_ffn")
    plan.append(("moe_ffn_on_mesh", (str(folder / "moe_ffn"),
                                     {case: (*v, MOE_FFN["cf"], MOE_FFN["k"])
                                      for case, v in MOE_FFN_CASES.items()})))
    plan.append(("mesh_refusals", (str(folder),)))
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


def _rank_rows(cfg, mesh, batch) -> list:
    """The slices of a batch each data rank decodes alone: one per data
    rank under the "manual" dispatch (its _manual_moe routes each data
    shard's tokens alone), else the whole batch."""
    if cfg.moe_dispatch_sharding != "manual":
        return [slice(0, batch)]
    n = batch // mesh[0]
    return [slice(r * n, (r + 1) * n) for r in range(mesh[0])]


def _reference_decode(arch, mesh, batch, folder, changes=None):
    """The reference's unsharded jitted serve step from init_params(key(0))
    over seeded tokens (on each data rank's rows alone under "manual"):
    the weights and tokens saved for the ranks, each step's logits, the
    final state's leaves by path ("k", "mlstm/c", ...) and their specs on
    the case's mesh as the reference's dry run places them
    (``_decode_state_shardings``) returned."""
    from repro.launch.dryrun import _decode_state_shardings

    rcfg = replace(r_get_smoke(arch), dtype="float32", **(changes or {}))
    params = jax.tree.map(np.asarray, r_lm.init_params(rcfg, jax.random.key(0)))
    workers.save_tree(str(folder / "params.npz"), params)
    tokens = np.random.default_rng(5).integers(0, rcfg.vocab, (DECODE["steps"], batch),
                                               dtype=np.int32)
    np.save(folder / "tokens.npy", tokens)
    step = jax.jit(r_make_serve_step(rcfg))
    parts = []
    for rows in _rank_rows(rcfg, mesh, batch):
        state = r_lm.init_decode_state(rcfg, rows.stop - rows.start, DECODE["seq"])
        logits = []
        for t in tokens:
            out, state = step(params, state, dict(tokens=jnp.asarray(t[rows])))
            logits.append(np.asarray(out))
        parts.append((np.stack(logits), _flat(jax.tree.map(np.asarray, state["cache"]))))
    whole = r_lm.init_decode_state(rcfg, batch, DECODE["seq"])
    rctx = r_sharding.MeshCtx(AbstractMesh(mesh, ("data", "model")))
    specs = _flat(_decode_state_shardings(rctx, whole)["cache"],
                  is_leaf=lambda x: hasattr(x, "spec"))
    cache = {k: np.concatenate([c[k] for _, c in parts], axis=1) for k in parts[0][1]}
    return dict(logits=np.concatenate([lg for lg, _ in parts], axis=1), cache=cache,
                specs={k: tuple(v.spec) for k, v in specs.items()})


def _reference_prefill(arch, mesh, changes, folder):
    """The reference's forward_loss metrics of synthetic_batch(0, 0,
    PREFILL["batch"], PREFILL["seq"]) from init_params(key(0)) (the mean
    of each data rank's rows' metrics under "manual"); the weights saved
    for the ranks."""
    rcfg = replace(r_get_smoke(arch), dtype="float32", **changes)
    params = jax.tree.map(np.asarray, r_lm.init_params(rcfg, jax.random.key(0)))
    workers.save_tree(str(folder / "params.npz"), params)
    batch = synthetic_batch(0, 0, PREFILL["batch"], PREFILL["seq"], rcfg.vocab)
    fn = jax.jit(lambda p, b: r_lm.forward_loss(rcfg, p, b)[1])
    runs = [fn(params, {k: jnp.asarray(v[rows]) for k, v in batch.items()})
            for rows in _rank_rows(rcfg, mesh, PREFILL["batch"])]
    return {k: float(np.mean([float(m[k]) for m in runs])) for k in runs[0]}


REF_MOE_FFN = """if True:
    import json, sys
    import numpy as np
    import jax
    from jax.sharding import AxisType
    from repro.models import moe
    from repro.models.sharding import set_mesh_ctx

    folder, cases = sys.argv[1], json.loads(sys.argv[2])
    k, cf = int(sys.argv[3]), float(sys.argv[4])
    with np.load(f"{folder}/params.npz") as z:
        params = {name: jax.numpy.asarray(z[name]) for name in z.files}
    for case, (shape, mode, xname) in cases.items():
        x = jax.numpy.asarray(np.load(f"{folder}/{xname}.npy"))
        mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        set_mesh_ctx(mesh)
        with mesh:
            y, aux = jax.jit(lambda p, x: moe.moe_ffn(p, x, top_k=k, capacity_factor=cf,
                                                      dispatch_sharding=mode))(params, x)
        set_mesh_ctx(None)
        np.savez(f"{folder}/ref_{case}.npz", y=np.asarray(y),
                 **{name: np.asarray(v) for name, v in aux.items()})
    print("REF_MOE_FFN done")
"""


def _reference_moe_ffn(folder):
    """MOE_FFN's weights and the two x, seeded with numpy, saved for the
    ranks; the reference's ``moe_ffn`` of each of MOE_FFN_CASES under its
    mesh, run once in a child process with 8 forced host devices (its
    outputs in ``folder``/ref_<case>.npz).  Returns the global routing's
    dropped slots of x8 (its capacity from all 128 tokens)."""
    rng = np.random.default_rng(11)
    d, e, f = MOE_FFN["d"], MOE_FFN["e"], MOE_FFN["f"]
    shapes = dict(router=(d, e), w_gate=(e, d, f), w_up=(e, d, f), w_down=(e, f, d),
                  sh_gate=(d, f), sh_up=(d, f), sh_down=(f, d))
    params = {k: (rng.standard_normal(v) / np.sqrt(v[-2])).astype(np.float32)
              for k, v in shapes.items()}
    np.savez(folder / "params.npz", **params)
    for name, b in (("x8", 8), ("x2", 2)):
        np.save(folder / f"{name}.npy", rng.standard_normal((b, 16, d)).astype(np.float32))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_MOE_FFN, str(folder),
                        json.dumps(MOE_FFN_CASES), str(MOE_FFN["k"]), str(MOE_FFN["cf"])],
                       capture_output=True, text=True, timeout=300, env=env)
    assert "REF_MOE_FFN done" in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]
    x = np.load(folder / "x8.npy").reshape(-1, d)
    idx = np.argsort(-(x @ params["router"]), axis=-1, kind="stable")[:, :MOE_FFN["k"]]
    cap = int(max(1, round(x.shape[0] * MOE_FFN["k"] / e * MOE_FFN["cf"])))
    seen, drops = np.zeros(e, np.int64), 0
    for ex in idx.T.reshape(-1):
        drops += int(seen[ex] >= cap)
        seen[ex] += 1
    return dict(drops=drops)


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
    arch, shape, batch, (leaf, dim, axis), *changes = DECODE_CASES[case]
    changes = changes[0] if changes else {}
    folder = mesh_runs["folder"] / case
    want = mesh_runs["refs"][case]
    with open(folder / "got.json") as f:
        meta = json.load(f)
    assert meta["wrong"] == []                # every parameter placed as its spec says
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
    cfg = replace(get_smoke(arch), dtype="float32", **changes)
    model = interop.lm_params_from_numpy(cfg, workers.load_tree(str(folder / "params.npz")),
                                         device="cpu")
    step = make_serve_step(cfg)
    for rows in _rank_rows(cfg, shape, batch):
        state = lm.init_decode_state(cfg, rows.stop - rows.start, DECODE["seq"], device="cpu")
        for i, t in enumerate(np.load(folder / "tokens.npy")):
            out, state = step(model, state, dict(tokens=torch.from_numpy(t[rows])))
            np.testing.assert_allclose(got["logits"][i, rows], out.numpy(), err_msg=f"step {i}",
                                       **tol)
        for path, leaf in _flat(state["cache"]).items():
            np.testing.assert_allclose(got[path][:, rows], leaf.numpy(), err_msg=path, **tol)


def test_decode_refuses_what_it_cannot_place(mesh_runs):
    """A sliding-window ring whose positions the rules split over ranks
    (hymba-smoke at batch 1 on (8, 1)), the hybrid family at model > 1 and
    the vlm family on a mesh raise ``NotImplementedError`` naming ROADMAP
    A2, before any cache is made or gathered."""
    with open(mesh_runs["folder"] / "refusals.json") as f:
        got = json.load(f)
    for what in ("ring", "hybrid", "vlm"):
        assert got[what] is not None and "ROADMAP A2" in got[what], (what, got[what])


@pytest.mark.parametrize("mode", ["manual", "grouped"])
def test_moe_training_refuses_the_dispatch_it_has_not_checked(mode, mesh_runs):
    """``make_train_step(mesh=)`` of the moe family under ``"manual"`` or
    ``"grouped"`` raises ``NotImplementedError`` naming ROADMAP A2, even at
    model = 1: there each data rank routes its own tokens as the
    reference's does, and no case holds that step's gradients against the
    reference's yet."""
    with open(mesh_runs["folder"] / "refusals.json") as f:
        got = json.load(f)[f"train-{mode}"]
    assert got is not None and "ROADMAP A2" in got and mode in got, got


@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_sharded_prefill_matches_the_reference(case, mesh_runs):
    """``make_prefill_step(mesh=)`` of the moe family with its experts split
    over ``model``: loss, nll, load_balance and z_loss against the
    reference's ``forward_loss`` on the same weights and batch (under
    "manual", the mean of its metrics on each data rank's rows alone, as
    its ``_manual_moe`` routes each data shard's tokens alone and averages
    the aux terms over them), every parameter placed as its spec says."""
    with open(mesh_runs["folder"] / case / "got.json") as f:
        got = json.load(f)
    assert got["wrong"] == []
    want = mesh_runs["refs"][case]
    assert set(got["metrics"]) == set(want) >= {"loss", "nll", "load_balance", "z_loss"}
    for key, value in want.items():
        np.testing.assert_allclose(got["metrics"][key], value, rtol=1e-4, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("case", list(MOE_FFN_CASES))
def test_moe_ffn_on_a_mesh_matches_the_reference(case, mesh_runs):
    """``moe_ffn`` with its weights split over ``model`` (E over it under
    the EP-only rules of "grouped", "manual" and "auto_ep", the experts'
    hidden f under the reference's default rules) and x over ``data``,
    against the reference's ``moe_ffn`` under the same mesh: the output
    gathered whole, ``load_balance`` and ``z_loss`` within MOE_FFN_TOL.
    The global routing of x8 drops slots at capacity factor 1.0."""
    shape, mode, _ = MOE_FFN_CASES[case]
    folder = mesh_runs["folder"] / "moe_ffn"
    got, want = np.load(folder / f"got_{case}.npz"), np.load(folder / f"ref_{case}.npz")
    ep = mode in ("grouped", "manual", "auto_ep")
    assert int(got["local_experts"]) == (MOE_FFN["e"] // shape[1] if ep else MOE_FFN["e"])
    np.testing.assert_allclose(got["y"], want["y"], **MOE_FFN_TOL)
    for key in ("load_balance", "z_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), **MOE_FFN_TOL,
                                   err_msg=key)
    assert mesh_runs["refs"]["moe_ffn"]["drops"] > 0


def test_moe_ffn_modes_part_where_the_reference_parts(mesh_runs):
    """On (4, 2) the reference's "manual" and "grouped" route each data
    shard alone and so differ from its "auto"; "auto_ep", "ep" (capacity
    under 256) and "tokens_dp" compute "auto"; the port's outputs part and
    agree alike."""
    folder = mesh_runs["folder"] / "moe_ffn"
    for pkg in ("ref", "got"):
        y = {m: np.load(folder / f"{pkg}_{m}-4x2.npz")["y"] for m in MOE_MODES}
        for m in ("auto_ep", "ep", "tokens_dp"):
            np.testing.assert_allclose(y[m], y["auto"], **MOE_FFN_TOL, err_msg=(pkg, m))
        for m in ("manual", "grouped"):
            assert np.abs(y[m] - y["auto"]).max() > 1e-3, (pkg, m)


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
    those of the reference's cache specs; deepseek-moe-16b's decode cell on
    16 x 16, its cache bytes those of the reference's specs; then the moe
    family's train cell and a hybrid cell skipped with their reasons."""
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
        out.append(dryrun_cell("deepseek-moe-16b", "decode_32k", verbose=False))
        assert "jax" not in sys.modules and "XLA_FLAGS" not in os.environ
        print(json.dumps(out))
    """
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    smoke, *granite, decode, moe = json.loads(r.stdout.strip().splitlines()[-1])
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
    # the moe family's decode cell on 16 x 16, its cache bytes those of the reference's specs
    assert moe["status"] == "ok" and moe["chips"] == 256, moe
    rcfg, shape = r_get_config("deepseek-moe-16b"), SHAPES["decode_32k"]
    rctx = r_sharding.MeshCtx(AbstractMesh((16, 16), ("data", "model")))
    kv = (rcfg.n_layers, shape.global_batch, shape.seq_len, rcfg.n_kv_heads, rcfg.d_head)
    spec = r_sharding.cache_spec(rctx, kv, seq_axis=2)
    shards = np.prod([rctx.mesh.shape[a] for a in spec if a is not None])
    itemsize = np.dtype(jnp.dtype(rcfg.dtype)).itemsize
    assert moe["memory"]["cache_bytes"] == 2 * np.prod(kv) * itemsize // shards
    assert moe["memory"]["param_bytes"] > 0 and moe["collectives"]["total"] > 0
    d = dryrun_cell("deepseek-moe-16b", "train_4k", verbose=False)
    assert d["status"] == "skipped" and "ROADMAP A2" in d["reason"], d
    d = dryrun_cell("hymba-1.5b", "decode_32k", verbose=False)
    assert d["status"] == "skipped" and "ROADMAP A2" in d["reason"], d
