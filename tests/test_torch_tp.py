"""The port's 'model' mesh axis, class (vocabulary) parallelism, on the CPU
(`yoloclip_tpu_torch/parallel/`).

  * Four gloo ranks as a 2x2 (data x model) grid, spawned once for the
    file, run the class-sharded train step; the references run here
    meanwhile:
      - against the JAX package's `make_sharded_train_step` over
        `create_mesh(n_data=2, n_model=2)` on the same weights and batch
        (variant 'n', 64 px, 4 images, 8 classes), with and without
        accumulation: loss within JAX's own 2e-4 relative
        (tests/test_train.py's sharded cases);
      - against the port's own 1-process step in float64 (weights, images,
        text; the losses stay float64 for a float64 model): loss parts,
        gradients and BatchNorm buffers within 1e-9 relative, the
        parameters after AdamW within 1e-9 absolute. Cases: the
        compat objective with accumulation 1 and 2, the clean objective
        (BCE), its softmax form with accumulation 2, and the trainer over
        prompts whose class bucket (8) leaves rank 1's block all padding,
        with `evaluate` (the same metrics). The steps run as programs
        (`make_sharded_train_step`'s default route, on the CPU the body
        over gloo without capture); 'clean_eager' runs the clean case
        through the eager DDP route, and the two routes agree within the
        same 1e-9;
      - one 64-px forward split 2-way in height over the model group
        (`parallel/spatial.py` through torch.distributed) against the
        unsplit forward, float64: within 1e-9.
  * In one process (threads over `collectives.LocalGroup`):
      - 16 persistent shard workers exchanging under contention (exact
        sums), and a failing shard that fails the call without a hang;
      - `class_max`'s gradient splits among exact ties over the whole
        class axis as `torch.amax`'s does (a local amax then a MAX
        all-reduce would not);
      - `merge_argmax` breaks ties to the lowest global id;
      - a shard whose num_valid is 0 (the plain path of kernels 1 and 3):
        NEG and id 0, and the merged result equals the unsharded one;
      - vocabulary-parallel inference over an in-process 2x2 mesh against
        the JAX model (ids exact, scores 1e-5, boxes 1e-3) and, in int8,
        against the port's single-device int8 forward at
        tests/test_quantize.py's bounds for sharded int8 inference.

Every spawned rank uses one thread, a `file://` rendezvous in tmp_path, a
60 s collective timeout, and a join timeout here.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.config import ModelConfig as JModelConfig
from yoloclip_tpu.config import TrainingConfig as JTrainingConfig
from yoloclip_tpu.models.yolo_clip import YOLOCLIP as JYOLOCLIP
from yoloclip_tpu.parallel.mesh import create_mesh as jax_create_mesh
from yoloclip_tpu.parallel.train_step import (make_sharded_train_step as
                                              jax_sharded_step,
                                              place_text as jax_place_text,
                                              replicate_state)
from yoloclip_tpu.train import train_state as jts
from yoloclip_tpu.utils.convert import convert_reference_state_dict
from yoloclip_tpu_torch.config import ModelConfig, TrainingConfig
from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP, init_weights
from yoloclip_tpu_torch.ops import quantize
from yoloclip_tpu_torch.ops.kernels import similarity as sim
from yoloclip_tpu_torch.parallel import collectives as col
from yoloclip_tpu_torch.parallel.mesh import create_mesh
from yoloclip_tpu_torch.parallel.train_step import make_sharded_inference
from yoloclip_tpu_torch.train import train_state as ts
from yoloclip_tpu_torch.train.trainer import YOLOCLIPTrainer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, M, C, B, LR = 64, 10, 8, 4, 1e-4
RTOL = 1e-9
PARAM_ATOL = 1e-9
JAX_LOSS_RTOL = 2e-4
JAX_CASES = {'jax_compat': dict(assigner='compat'),
             'jax_compat_accum2': dict(assigner='compat',
                                       grad_accum_steps=2)}
CASES = {   # float64
    'compat': dict(assigner='compat'),
    'compat_accum2': dict(assigner='compat', grad_accum_steps=2),
    'clean': dict(assigner='topk_center'),
    'clean_softmax_accum2': dict(assigner='topk_center',
                                 contrastive_type='softmax',
                                 grad_accum_steps=2),
    'trainer_padded_block': dict(assigner='compat'),
    'clean_eager': dict(assigner='topk_center'),   # 'clean', eager route
}
PROMPTS = [f'p{i}' for i in range(3)]   # bucket 8: rank 1's block 4..7


def _batch(case):
    """A case's global batch, numpy, from a seed (an '_eager' case takes
    its program case's)."""
    rs = np.random.RandomState(len(case.removesuffix('_eager')))
    xy = rs.rand(B, M, 2) * SIZE * 0.7
    wh = rs.rand(B, M, 2) * SIZE * 0.3 + 4
    batch = {'images': rs.rand(B, SIZE, SIZE, 3).astype(np.float32),
             'boxes': np.concatenate([xy, xy + wh], -1).astype(np.float32),
             'class_ids': rs.randint(0, 3, (B, M)).astype(np.int32),
             'valid_mask': rs.rand(B, M) > 0.3}
    text = rs.randn(B, C, 512).astype(np.float32)
    if case.startswith('trainer'):
        batch['text_prompts'] = [list(PROMPTS)] * B
    return batch, text


class StubTextEncoder:
    """Deterministic per-prompt unit rows, the same in every process."""

    def __call__(self, prompts):
        import zlib
        rows = []
        for p in prompts:
            v = np.random.RandomState(zlib.crc32(p.encode())).randn(512)
            rows.append(v / np.linalg.norm(v))
        return torch.tensor(np.stack(rows), dtype=torch.float32)


WORKER = r'''
import sys, zlib
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from yoloclip_tpu_torch.config import ModelConfig, TrainingConfig
from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP
from yoloclip_tpu_torch.parallel import multihost, spatial
from yoloclip_tpu_torch.parallel.mesh import create_mesh
from yoloclip_tpu_torch.parallel.train_step import (make_sharded_train_step,
                                                    place_batch, place_text)
from yoloclip_tpu_torch.train import train_state as ts
from yoloclip_tpu_torch.train.trainer import YOLOCLIPTrainer


class StubTextEncoder:
    def __call__(self, prompts):
        rows = []
        for p in prompts:
            v = np.random.RandomState(zlib.crc32(p.encode())).randn(512)
            rows.append(v / np.linalg.norm(v))
        return torch.tensor(np.stack(rows), dtype=torch.float32)


rank, tmp = int(sys.argv[1]), sys.argv[3]
multihost.initialize(sys.argv[2], 4, rank, device='cpu', timeout_s=60)
mesh = create_mesh(n_data=2, n_model=2)
inp = torch.load(tmp + '/inputs.pt', weights_only=False)
lr = inp['lr']
out = {'mesh': (mesh.rank, mesh.model_index)}

def digest_equal(model):
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    lo, hi = flat.clone(), flat.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    return bool(torch.equal(lo, hi))

for case, (kw, dtype, batch, text) in inp['cases'].items():
    cfg = TrainingConfig(model=ModelConfig(image_size=(64, 64)), **kw)
    model = YOLOCLIP(cfg.model)
    model.load_state_dict(inp['weights'])
    model = model.to(dtype)
    state = ts.TrainState(model, ts.make_optimizer(cfg, model.parameters()))
    ts.set_learning_rate(state, lr)
    res = {}
    if 'text_prompts' in batch:   # through the trainer (the class bucket)
        trainer = YOLOCLIPTrainer(model, StubTextEncoder(), cfg, state=state,
                                  mesh=mesh, device='cpu')
        trainer._schedule = lambda count: lr
        parts = trainer.train_epoch([batch], 1)
        res['eval'] = trainer.evaluate([batch])
    else:
        accum = cfg.grad_accum_steps
        step = make_sharded_train_step(
            cfg, mesh, eager=case.endswith('_eager'))(state)
        local = place_batch(batch, mesh, accum)
        t = place_text(text, mesh, accum=accum).to(dtype)
        res['block'] = tuple(t.shape)
        local['images'] = local['images'].to(dtype)
        parts = {k: float(v) for k, v in step(state, local, t).items()}
    res.update(parts=parts, identical=digest_equal(model))
    if rank == 0:
        res['grads'] = {k: p.grad.clone() for k, p in
                        model.named_parameters()}
        res['state'] = {k: v.clone() for k, v in model.state_dict().items()}
    out[case] = res

# a 2-way height split over the model group, float64
cfg = ModelConfig(image_size=(64, 64))
model = YOLOCLIP(cfg)
model.load_state_dict(inp['weights'])
model = model.to(torch.float64).eval()
images, text = inp['spatial']
shard = spatial.HeightShard((1, 1), mesh.model_index, mesh.model_group)
with torch.no_grad(), spatial.partition(shard):
    got = model(shard.split(images, 1), text)
if rank == 0:
    out['spatial'] = {k: got[k] for k in ('scores', 'class_ids', 'boxes')}
torch.save(out, f'{tmp}/rank{rank}.pt')
multihost.shutdown()
'''


@pytest.fixture(scope='module')
def weights():
    """A seeded port init as a torch state dict and as flax variables."""
    model = YOLOCLIP(ModelConfig(image_size=(SIZE, SIZE)))
    init_weights(model, torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    variables = convert_reference_state_dict(
        sd, JModelConfig(image_size=(SIZE, SIZE)), with_aux_box=False)
    return sd, jax.tree_util.tree_map(jnp.asarray, variables)


def _spatial_inputs():
    rs = np.random.RandomState(21)
    return (torch.from_numpy(rs.rand(2, SIZE, SIZE, 3)).double(),
            torch.from_numpy(rs.randn(C, 512)).double())


@pytest.fixture(scope='module')
def ranks(weights, tmp_path_factory):
    """Start the four ranks, then hand out a function that waits for them
    and returns their results by rank."""
    tmp = tmp_path_factory.mktemp('tp')
    cases = {}
    for case, kw in {**JAX_CASES, **CASES}.items():
        batch, text = _batch(case)
        cases[case] = (dict(kw, max_objects=M, batch_size=B,
                            output_dir=str(tmp / case)),
                       torch.float32 if case in JAX_CASES else torch.float64,
                       batch, text)
    torch.save({'weights': weights[0], 'cases': cases, 'lr': LR,
                'spatial': _spatial_inputs()}, tmp / 'inputs.pt')
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    rdv = f'file://{tmp}/rendezvous'
    procs = [subprocess.Popen(
        [sys.executable, '-c', WORKER, str(r), rdv, str(tmp)], env=env,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    got = {}

    def results():
        if not got:
            try:
                logs = [p.communicate(timeout=400)[0] for p in procs]
            finally:
                for p in procs:
                    p.kill()
            for r, (p, log) in enumerate(zip(procs, logs)):
                assert p.returncode == 0, f'rank {r}:\n{log[-4000:]}'
            got.update({r: torch.load(tmp / f'rank{r}.pt')
                        for r in range(4)})
        return got

    yield results
    for p in procs:
        p.kill()


def _cfg(**kw):
    return TrainingConfig(model=ModelConfig(image_size=(SIZE, SIZE)),
                          max_objects=M, batch_size=B, **kw)


@pytest.mark.parametrize('case', list(JAX_CASES))
def test_2x2_step_matches_jax_sharded_step(weights, ranks, case):
    """JAX's step over its 2x2 mesh (batch over 'data', classes over
    'model'), as tests/test_train.py's sharded cases run it."""
    _, variables = weights
    jcfg = JTrainingConfig(model=JModelConfig(image_size=(SIZE, SIZE)),
                           max_objects=M, batch_size=B, **JAX_CASES[case])
    model = JYOLOCLIP(jcfg.model)
    tx = jts.make_optimizer(jcfg)
    params = jax.tree_util.tree_map(jnp.array, variables['params'])
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree_util.tree_map(
                               jnp.array, variables['batch_stats']),
                           opt_state=tx.init(params), tx=tx,
                           apply_fn=model.apply)
    mesh = jax_create_mesh(n_data=2, n_model=2)
    batch, text = _batch(case)
    with mesh:
        state = replicate_state(state, mesh)
        _, jparts = jax_sharded_step(jcfg, mesh)(state)(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jax_place_text(text, mesh))
    got = ranks()
    for r in range(4):
        assert got[r][case]['identical']
        assert got[r][case]['parts'] == got[0][case]['parts']
    w = float(jparts['loss'])
    assert got[0][case]['parts']['loss'] == pytest.approx(
        w, rel=JAX_LOSS_RTOL)


def _single(sd, case, tmp):
    """The port's 1-process step (or trainer epoch) on the global batch,
    float64."""
    cfg = _cfg(output_dir=str(tmp), **CASES[case])
    model = YOLOCLIP(cfg.model)
    model.load_state_dict(sd)
    model = model.double()
    state = ts.TrainState(model, ts.make_optimizer(cfg, model.parameters()))
    ts.set_learning_rate(state, LR)
    batch, text = _batch(case)
    ev = None
    if case.startswith('trainer'):
        trainer = YOLOCLIPTrainer(model, StubTextEncoder(), cfg, state=state,
                                  device='cpu')
        trainer._schedule = lambda count: LR
        parts = trainer.train_epoch([batch], 1)
        ev = trainer.evaluate([batch])
    else:
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        tb['images'] = tb['images'].double()
        parts = ts.make_train_step(cfg)(state, tb,
                                        torch.from_numpy(text).double())
        parts = {k: float(v) for k, v in parts.items()}
    return parts, model, ev


def _close(got, want, what):
    assert abs(got - want) <= RTOL * max(abs(want), 1e-30), (what, got,
                                                             want)


@pytest.mark.parametrize('case', list(CASES))
def test_2x2_step_matches_single_process_float64(weights, ranks, case,
                                                  tmp_path):
    """Loss parts, gradients (the gradient every rank applied: DDP's mean
    over the world of the model ranks' shares) and BatchNorm buffers."""
    want, model, ev = _single(weights[0], case, tmp_path)
    got = ranks()
    for r in range(4):
        assert got[r][case]['identical'], r
        assert got[r][case]['parts'] == got[0][case]['parts'], r
    if 'block' in got[0][case]:   # each rank: 2 rows, a block of 4
        assert {got[r][case]['block'] for r in range(4)} == {(2, 4, 512)}
    r0 = got[0][case]
    for k, w in want.items():
        _close(r0['parts'][k], w, k)
    for k, p in model.named_parameters():
        g, w = r0['grads'][k], p.grad
        assert float((g - w).norm()) <= RTOL * max(float(w.norm()),
                                                   1e-30), k
    for k, v in model.state_dict().items():
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(r0['state'][k].numpy(), v.numpy(),
                                       rtol=RTOL, atol=1e-12, err_msg=k)
        elif v.is_floating_point():
            # AdamW's first step is lr * sign(g) where |g| >> eps: a
            # near-zero gradient's rounding moves it, so the parameters
            # agree to a fraction of the step (lr = 1e-4)
            np.testing.assert_allclose(r0['state'][k].numpy(), v.numpy(),
                                       rtol=0, atol=PARAM_ATOL, err_msg=k)
    if ev is not None:
        for r in range(4):
            for k, w in ev.items():
                _close(got[r][case]['eval'][k], w, k)


def test_2x2_program_matches_eager_ddp_route(ranks):
    """The class-sharded clean step through the program and through the
    eager DDP route (its gradient average a sum over four ranks, in
    either route's order): loss parts, gradients and state within 1e-9."""
    got = ranks()
    for r in range(4):
        prog, eager = got[r]['clean'], got[r]['clean_eager']
        for k, w in eager['parts'].items():
            _close(prog['parts'][k], w, k)
    prog, eager = got[0]['clean'], got[0]['clean_eager']
    for k, w in eager['grads'].items():
        assert float((prog['grads'][k] - w).norm()) <= RTOL * max(
            float(w.norm()), 1e-30), k
    for k, w in eager['state'].items():
        if w.is_floating_point():
            np.testing.assert_allclose(prog['state'][k].numpy(), w.numpy(),
                                       rtol=RTOL, atol=PARAM_ATOL,
                                       err_msg=k)


def test_spatial_split_over_process_group(weights, ranks):
    images, text = _spatial_inputs()
    model = YOLOCLIP(ModelConfig(image_size=(SIZE, SIZE)))
    model.load_state_dict(weights[0])
    model = model.double().eval()
    with torch.no_grad():
        want = model(images, text)
    got = ranks()[0]['spatial']
    assert torch.equal(got['class_ids'], want['class_ids'])
    for k in ('scores', 'boxes'):
        assert float((got[k] - want[k]).abs().max()) <= RTOL * float(
            want[k].abs().max())


# ---------------------------------------------------------------------------
# in one process: the model-axis helpers over threads
# ---------------------------------------------------------------------------

def _over_shards(n, fn):
    """fn(rank, group member) on n threads of one LocalGroup."""
    group, workers = col.LocalGroup(n), col.ShardThreads(n)
    try:
        return workers.run([lambda r=r: fn(r, group.member(r))
                            for r in range(n)], [group])
    finally:
        workers.close()


def test_shard_threads_exchange_under_contention():
    """More workers than cores, a short switch interval, many exchanges
    through one group: every sum is exact on every shard (a lost or
    mixed-up slot would break it); a shard that raises fails the call
    without leaving the others waiting, and the workers serve the next
    call."""
    n, rounds = 16, 100
    workers = col.ShardThreads(n)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        group = col.LocalGroup(n)

        def shard(r):
            out = []
            for i in range(rounds):
                y = col.all_reduce_sum(torch.tensor([float(r + i)]),
                                       group.member(r))
                out.append(float(y))
            return out

        got = workers.run([lambda r=r: shard(r) for r in range(n)],
                          [group])
        want = [n * i + n * (n - 1) / 2 for i in range(rounds)]
        assert all(g == want for g in got)

        bad = col.LocalGroup(n)

        def failing(r):
            if r == 3:
                raise ValueError('shard 3 failed')
            return col.group_sum(torch.ones(1), bad.member(r))

        with pytest.raises(ValueError, match='shard 3'):
            workers.run([lambda r=r: failing(r) for r in range(n)], [bad])
        again = col.LocalGroup(n)
        assert workers.run([lambda r=r: float(col.group_sum(
            torch.ones(1), again.member(r))) for r in range(n)],
            [again]) == [float(n)] * n
    finally:
        sys.setswitchinterval(old)
        workers.close()


def test_class_max_tie_gradient_matches_amax():
    """Ties: shard 0 holds two entries equal to the max, shard 1 one. The
    unsharded amax gives each a third of the gradient; a local amax then a
    MAX all-reduce would give 1/4, 1/4 and 1/2."""
    x = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0],
                      [0.0, -1.0, 4.0, 4.0, -2.0, 1.0]], dtype=torch.float64)
    w = torch.tensor([[2.0], [-3.0]], dtype=torch.float64)
    xr = x.clone().requires_grad_()
    (xr.amax(dim=1, keepdim=True) * w).sum().backward()

    def shard(r, g):
        xs = x[:, 3 * r:3 * r + 3].clone().requires_grad_()
        y = col.class_max(xs, 1, g)
        # every rank's loss reads y: the ranks' losses sum to the
        # unsharded one when each is divided by the rank count
        ((y * w).sum() / 2).backward()
        return y.detach(), xs.grad

    (y0, g0), (y1, g1) = _over_shards(2, shard)
    assert torch.equal(y0, y1) and torch.equal(y0, x.amax(1, keepdim=True))
    np.testing.assert_allclose(torch.cat([g0, g1], 1).numpy(),
                               xr.grad.numpy(), rtol=0, atol=1e-15)
    assert xr.grad[0, 1] == pytest.approx(2.0 / 3)


def test_merge_argmax_ties_go_to_the_lowest_global_id():
    # shard r holds global ids [3r, 3r + 3)
    scores = [torch.tensor([5.0, 1.0, 2.0, 7.0]),
              torch.tensor([5.0, 3.0, 2.0, 7.5])]
    ids = [torch.tensor([2, 0, 1, 0], dtype=torch.int32),
           torch.tensor([0, 1, 1, 2], dtype=torch.int32)]
    out = _over_shards(2, lambda r, g: col.merge_argmax(
        scores[r], ids[r], 3 * r, g))
    for s, i in out:
        assert s.tolist() == [5.0, 3.0, 2.0, 7.5]
        assert i.tolist() == [2, 4, 1, 5] and i.dtype == torch.int32


@pytest.mark.parametrize('mode', ['folded', 'unprojected'])
def test_shard_with_no_valid_class(mode):
    """num_valid = 5 of 8 classes over 2 shards of 4 (4 and 1 valid), and
    num_valid = 3 (shard 1 has none): shard 1's launch is the masked NEG
    and id 0, and the merge equals the unsharded result."""
    g = torch.Generator().manual_seed(3)
    text = torch.randn(2, C, 128, generator=g)
    text = text / text.norm(dim=-1, keepdim=True)
    if mode == 'folded':
        h = torch.randn(2, 37, 128, generator=g)
        k, b = torch.randn(128, 128, generator=g), torch.randn(128,
                                                               generator=g)
        whole = lambda nv: sim.fused_projected_similarity_argmax(  # noqa
            h, text, k, b, nv)
        part = lambda t, sh, nv: sim.sharded_projected_similarity_argmax(  # noqa
            h, t, k, b, sh, nv)
        local = lambda t, nv: sim.fused_projected_similarity_argmax(  # noqa
            h, t, k, b, nv)
    else:
        obj = torch.randn(2, 37, 128, generator=g)
        whole = lambda nv: sim.fused_similarity_argmax(  # noqa: E731
            obj, text, nv, normalize_obj=True)
        part = lambda t, sh, nv: sim.sharded_similarity_argmax(  # noqa
            obj, t, sh, nv, normalize_obj=True)
        local = lambda t, nv: sim.fused_similarity_argmax(  # noqa: E731
            obj, t, nv, normalize_obj=True)
    for nv in (5, 3):
        want = whole(nv)

        def shard(r, grp):
            sh = col.ClassShard(*col.class_block(C, 2, r), C, grp)
            assert sim.shard_num_valid(nv, sh) == max(0, min(nv - 4 * r, 4))
            return part(sh.take(text), sh, nv)

        for s, i in _over_shards(2, shard):
            # the blocks' products may round apart from the whole's
            assert torch.equal(i, want[1])
            np.testing.assert_allclose(s.numpy(), want[0].numpy(), rtol=0,
                                       atol=1e-6)
    s1, i1 = local(text[:, 4:], 0)
    assert bool((i1 == 0).all()) and bool((s1 < -1e20).all())   # NEG / norm


def _sharded_outputs(model, images, text, mesh):
    outs = make_sharded_inference(model, mesh)(images, text)
    return {k: torch.cat([o[k] for o in outs])
            for k in ('scores', 'class_ids', 'boxes')}


@pytest.fixture(scope='module')
def infer_inputs():
    rs = np.random.RandomState(3)
    images = rs.rand(4, 128, 128, 3).astype(np.float32)
    text = rs.randn(C, 512).astype(np.float32)
    model = YOLOCLIP(ModelConfig(image_size=(128, 128)))
    init_weights(model, torch.Generator().manual_seed(1))
    return model.eval(), images, text


def test_vocab_parallel_inference_matches_jax(infer_inputs):
    """Batch over 'data', classes over 'model' (in-process 2x2, threads)
    against the JAX model on the same weights, and the port's unsharded
    forward (ids exact, scores 1e-6)."""
    model, images, text = infer_inputs
    jcfg = JModelConfig(image_size=(128, 128))
    variables = convert_reference_state_dict(
        {k: v.clone() for k, v in model.state_dict().items()}, jcfg,
        with_aux_box=False)
    jout = jax.jit(JYOLOCLIP(jcfg).apply)(variables, jnp.asarray(images),
                                          jnp.asarray(text))
    mesh = create_mesh(2, 2, devices=['cpu'] * 4)
    got = _sharded_outputs(model, torch.from_numpy(images),
                           torch.from_numpy(text), mesh)
    with torch.inference_mode():
        one = model(torch.from_numpy(images), torch.from_numpy(text))
    # row and class blocks may round apart from the whole batch's
    assert torch.equal(got['class_ids'], one['class_ids'])
    np.testing.assert_allclose(got['scores'].numpy(), one['scores'].numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got['class_ids'].numpy(),
                                  np.asarray(jout['class_ids']))
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(jout['scores']), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got['boxes'].numpy(),
                               np.asarray(jout['boxes']), rtol=0, atol=1e-3)


def test_sharded_int8_inference_matches_single_device(infer_inputs):
    """The W8A8 model over the 2x2 mesh (batch over data, vocabulary over
    model) against the single-device int8 forward, at
    tests/test_quantize.py's bounds."""
    model, images, text = infer_inputs
    x, t = torch.from_numpy(images), torch.from_numpy(text)
    qmodel = quantize.quantize_model(copy_model(model),
                                     quantize.float_state(model), [(x, t)])
    with torch.inference_mode():
        single = qmodel(x, t)
    got = _sharded_outputs(qmodel, x, t, create_mesh(2, 2,
                                                     devices=['cpu'] * 4))
    np.testing.assert_allclose(got['boxes'].numpy(),
                               single['boxes'].numpy(), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got['scores'].numpy(),
                               single['scores'].numpy(), rtol=1e-3,
                               atol=2e-3)


def copy_model(model):
    import copy
    return copy.deepcopy(model)
