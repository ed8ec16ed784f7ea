"""The port's data-parallel training (`yoloclip_tpu_torch/parallel/`) on the
CPU: two gloo ranks, spawned once for the whole file, run every case; the
references run here meanwhile.

  * The 2-rank DistributedDataParallel step against the JAX package's
    `make_sharded_train_step` over `create_mesh(n_data=2, n_model=1)` on
    the same global batch and weights (variant 'n', 128 px, 4 images), at
    `test_torch_train.py`'s tolerances for the 1-process step: loss parts
    3e-5 relative, gradients 1e-3 relative L2, BatchNorm buffers 2e-5. The
    JAX step runs SGD at lr 1e4, so its gradient is (p0 - p1) / 1e4.
  * The 2-rank step against the port's own 1-process step on the global
    batch, tighter: loss parts 1e-6 relative; gradients 1e-5 relative L2;
    BatchNorm buffers and the parameters after AdamW 1e-5 absolute. These
    run at 64 px with float64 weights (the losses stay fp32): in fp32 the
    two agree only as far as rounding allows through train-mode BatchNorm,
    whose backward amplifies it (measured at 128 px: gradients 1e-3
    relative, and AdamW's first step, +-lr for any gradient far from 0,
    flips where a near-zero gradient changes sign), while a difference of
    the computation itself shows far above the tolerances (measured with
    the statistics left per rank: the compat loss 9.4e-4 relative off;
    with per-rank normalisers 8.9e-6 to 2.2; with the rank's own class
    bucket 6.2e-5). Cases:
    both objectives, accumulation 1 and 2, ranks whose samples have
    different vocabulary sizes (through the trainer: the class bucket),
    and a rank with no valid box (the global normalisers); the ranks'
    parameters after the step are identical bit for bit. These steps run
    as programs (`make_sharded_train_step`'s default route; on the CPU a
    program runs its body over gloo without capture), so the JAX case
    holds the program route to JAX's sharded step.
  * The program route against the eager DistributedDataParallel route
    from the same weights and state, two steps with EMA, bit for bit
    (loss parts, parameters, BatchNorm buffers, AdamW moments, EMA: the
    average over two ranks is one scaling by 1/2 and one sum of two
    values either way): accumulation 2, the clean objective, a rank with
    no valid box, and the trainer over ragged vocabularies. The eval
    program with NMS against the eager eval step (losses and predictions
    equal). Batches of other shapes on the two ranks raise
    `ProgramKeyMismatch` on both, naming both keys; gloo on a CUDA device
    is refused (`capture_blocker`). In one process, a one-cell mesh's
    step is the 1-device 'train_step' program.
  * BatchNorm2d with a group (equal and unequal shards) against flax's
    BatchNorm over the concatenated batch: outputs 1e-5, buffers 1e-6,
    gradients 1e-5.
  * The contrastive loss's minimum positive count with multi-hot labels
    whose local minima differ (the JAX package's loss over the whole batch
    is the reference).
  * The mesh helpers: `process_local_indices`, `Subset`,
    `local_batch_size`, `batch_sharding`, and the grid's layout with a
    'model' axis.

Every spawned rank uses one thread, a `file://` rendezvous in tmp_path, a
60 s collective timeout, and a join timeout here, so a hung collective
fails its test instead of the run.
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
                                              replicate_state)
from yoloclip_tpu.train import train_state as jts
from yoloclip_tpu.train.losses import (region_text_contrastive_loss as
                                       jax_contrastive)
from yoloclip_tpu.utils.convert import convert_reference_state_dict
from yoloclip_tpu_torch.config import ModelConfig, TrainingConfig
from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP, init_weights
from yoloclip_tpu_torch.parallel import mesh as pmesh
from yoloclip_tpu_torch.parallel import multihost
from yoloclip_tpu_torch.train import train_state as ts
from yoloclip_tpu_torch.train.trainer import YOLOCLIPTrainer
from yoloclip_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, SMALL, M, C, B, LR = 128, 64, 10, 8, 4, 1e-4
JAX_SGD_LR = 1e4
LOSS_RTOL, GRAD_RTOL, STATE_ATOL = 1e-6, 1e-5, 1e-5
JAX_LOSS_RTOL, JAX_GRAD_RTOL, JAX_BUF_ATOL = 3e-5, 1e-3, 2e-5
JAX_CASE = 'compat_fp32'
CASES = {   # float64 weights, except JAX_CASE
    JAX_CASE: dict(assigner='compat'),
    'compat': dict(assigner='compat'),
    'compat_accum2': dict(assigner='compat', grad_accum_steps=2),
    'clean': dict(assigner='topk_center'),
    'clean_accum2': dict(assigner='topk_center', grad_accum_steps=2),
    'empty_rank_compat': dict(assigner='compat'),
    'empty_rank_clean': dict(assigner='topk_center'),
    'ragged_vocab': dict(assigner='compat'),
}
BN_SPLITS = {'equal': 2, 'unequal': 3}   # rank 0's rows of 4
# program vs eager DDP route, two steps with EMA
GRAPH_CASES = ('compat_accum2', 'clean', 'empty_rank_clean', 'ragged_vocab')
GRAPH_EMA = 0.99


def _size(case):
    return SIZE if case == JAX_CASE else SMALL


def _dtype(case):
    return torch.float32 if case == JAX_CASE else torch.float64


def _cfg(size=SIZE, **kw):
    return TrainingConfig(model=ModelConfig(image_size=(size, size)),
                          max_objects=M, batch_size=B, **kw)


def _batch(case):
    """The global batch of a case, numpy, from a seed."""
    S = _size(case)
    rs = np.random.RandomState(len(case))
    xy = rs.rand(B, M, 2) * S * 0.7
    wh = rs.rand(B, M, 2) * S * 0.3 + 4
    batch = {'images': rs.rand(B, S, S, 3).astype(np.float32),
             'boxes': np.concatenate([xy, xy + wh], -1).astype(np.float32),
             'class_ids': rs.randint(0, 3, (B, M)).astype(np.int32),
             'valid_mask': rs.rand(B, M) > 0.3}
    text = rs.randn(B, C, 512).astype(np.float32)
    if case.startswith('empty_rank'):
        batch['valid_mask'][B // 2:] = False   # rank 1's rows
    if case == 'ragged_vocab':   # rank 0's samples 5 prompts, rank 1's 12
        batch['text_prompts'] = ([[f'p{i}' for i in range(5)]] * (B // 2)
                                 + [[f'q{i}' for i in range(12)]] * (B // 2))
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


def _bn_inputs():
    rs = np.random.RandomState(5)
    ch = 16
    return {'x': (rs.randn(4, ch, 5, 4) * 2 + 0.5).astype(np.float32),
            'g': rs.randn(4, ch, 5, 4).astype(np.float32),
            'rm': rs.randn(ch).astype(np.float32),
            'rv': rs.rand(ch).astype(np.float32),
            'scale': rs.rand(ch).astype(np.float32) + 0.5,
            'bias': rs.randn(ch).astype(np.float32)}


def _min_inputs():
    """Multi-hot labels: rank 0's rows (0, 1) have >= 2 positives a slot,
    rank 1's (2, 3) exactly 1, so the local minima are 2 and 1."""
    rs = np.random.RandomState(9)
    labels = np.zeros((4, 6, 5), np.float32)
    for b in range(4):
        for m in range(6):
            k = 2 + (m % 2) if b < 2 else 1
            labels[b, m, rs.choice(5, k, replace=False)] = 1.0
    return (rs.randn(4, 6, 32).astype(np.float32),
            rs.randn(4, 5, 32).astype(np.float32), labels,
            rs.rand(4, 6) > 0.2)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

WORKER = r'''
import sys, zlib
import numpy as np
import torch
torch.set_num_threads(1)
from yoloclip_tpu_torch.config import ModelConfig, TrainingConfig
from yoloclip_tpu_torch.models.layers import BatchNorm2d
from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP
from yoloclip_tpu_torch.parallel import multihost
from yoloclip_tpu_torch.parallel.mesh import create_mesh
from yoloclip_tpu_torch.inference.program import ProgramKeyMismatch
from yoloclip_tpu_torch.parallel.collectives import capture_blocker
from yoloclip_tpu_torch.parallel.train_step import (make_sharded_eval_step,
                                                    make_sharded_train_step,
                                                    place_batch)
from yoloclip_tpu_torch.train import train_state as ts
from yoloclip_tpu_torch.train.losses import region_text_contrastive_loss
from yoloclip_tpu_torch.train.trainer import YOLOCLIPTrainer


class StubTextEncoder:
    def __call__(self, prompts):
        rows = []
        for p in prompts:
            v = np.random.RandomState(zlib.crc32(p.encode())).randn(512)
            rows.append(v / np.linalg.norm(v))
        return torch.tensor(np.stack(rows), dtype=torch.float32)


rank, tmp = int(sys.argv[1]), sys.argv[3]
multihost.initialize(sys.argv[2], 2, rank, device='cpu', timeout_s=60)
mesh = create_mesh()
inp = torch.load(tmp + '/inputs.pt', weights_only=False)
lr = inp['lr']
out = {}

def digest_equal(model):
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    lo, hi = flat.clone(), flat.clone()
    torch.distributed.all_reduce(lo, op=torch.distributed.ReduceOp.MIN)
    torch.distributed.all_reduce(hi, op=torch.distributed.ReduceOp.MAX)
    return bool(torch.equal(lo, hi))

def route(case, eager, ema, steps, first=None):
    """`steps` steps through the program route or (eager) the DDP route,
    with an EMA where ema; first(model) after the first step. Returns the
    config, the state, each step's loss parts and every state tensor."""
    kw, size, dtype, batch, text = inp['cases'][case]
    cfg = TrainingConfig(model=ModelConfig(image_size=(size, size)),
                         **dict(kw, ema_decay=inp['graph_ema'] if ema
                                else 0.0))
    model = YOLOCLIP(cfg.model)
    model.load_state_dict(inp['weights'])
    model = model.to(dtype)
    state = ts.TrainState(model, ts.make_optimizer(cfg, model.parameters()),
                          {k: p.detach().clone()
                           for k, p in model.named_parameters()}
                          if ema else None)
    ts.set_learning_rate(state, lr)
    if 'text_prompts' in batch:   # through the trainer (the class bucket)
        trainer = YOLOCLIPTrainer(model, StubTextEncoder(), cfg, state=state,
                                  mesh=mesh, device='cpu')
        trainer._schedule = lambda count: lr
        if eager:
            trainer._train_step = trainer._train_step_eager
        run = lambda: trainer.train_epoch([batch], 1)
    else:
        step = make_sharded_train_step(cfg, mesh, eager=eager)(state)
        local = place_batch(dict(batch, text=text), mesh,
                            cfg.grad_accum_steps)
        t = local.pop('text').to(dtype)
        local['images'] = local['images'].to(dtype)
        run = lambda: {k: float(v) for k, v in step(state, local, t).items()}
    parts = []
    for i in range(steps):
        parts.append(run())
        if i == 0 and first is not None:
            first(model)
    tensors = dict(model.state_dict())
    tensors.update({'ema ' + k: v for k, v in (state.ema or {}).items()})
    for name, p in model.named_parameters():
        for k, v in state.optimizer.state[p].items():
            tensors[f'optimizer {name} {k}'] = v
    return cfg, state, parts, tensors

def record(case):
    def first(model):
        res = {'identical': digest_equal(model)}
        if rank == 0:
            res['grads'] = {k: p.grad.clone() for k, p in
                            model.named_parameters()}
            res['state'] = {k: v.clone()
                            for k, v in model.state_dict().items()}
        out[case] = res
    return first

for case in inp['cases']:
    # the program route; a GRAPH case takes a second step, with an EMA,
    # and then the eager route from the same weights
    graph = case in inp['graph_cases']
    cfg, state, parts, tensors = route(case, False, graph, 1 + graph,
                                       record(case))
    out[case]['parts'] = parts[0]
    if not graph:
        continue
    _, _, eparts, etensors = route(case, True, True, 2)
    res = {'parts': parts, 'eager_parts': eparts, 'n': len(tensors),
           'differ': [k for k, v in etensors.items()
                      if not torch.equal(tensors[k], v)]}
    if case == 'clean':   # the eval program with NMS vs the eager step
        _, _, dtype, batch, text = inp['cases'][case]
        cfg = TrainingConfig(model=cfg.model, eval_with_nms=True,
                             eval_conf_threshold=-1.0,
                             max_objects=cfg.max_objects)
        local = place_batch(dict(batch, text=text), mesh)
        t = local.pop('text').to(dtype)
        local['images'] = local['images'].to(dtype)
        res['eval'] = [make_sharded_eval_step(cfg, mesh, eager=eager)(
            state, local, t) for eager in (False, True)]
    out['graph_' + case] = res

# the ranks pass batches of other shapes: both raise, naming the keys
kw, size, dtype, batch, text = inp['cases']['clean']
cfg = TrainingConfig(model=ModelConfig(image_size=(size, size)), **kw)
model = YOLOCLIP(cfg.model).to(dtype)
state = ts.TrainState(model, ts.make_optimizer(cfg, model.parameters()))
local = place_batch(dict(batch, text=text), mesh)
t = local.pop('text').to(dtype)
local['images'] = local['images'].to(dtype)
if rank == 1:
    local, t = {k: v[:1] for k, v in local.items()}, t[:1]
try:
    make_sharded_train_step(cfg, mesh)(state)(state, local, t)
    out['mismatch'] = None
except ProgramKeyMismatch as e:
    out['mismatch'] = str(e)
out['blocker'] = (capture_blocker('cuda:0', mesh.group),
                  capture_blocker('cpu', mesh.group))

bn_in = inp['bn']
for name, n0 in inp['bn_splits'].items():
    rows = slice(0, n0) if rank == 0 else slice(n0, None)
    bn = BatchNorm2d(bn_in['x'].shape[1])
    bn.group = mesh.group
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(bn_in['scale']))
        bn.bias.copy_(torch.from_numpy(bn_in['bias']))
        bn.running_mean.copy_(torch.from_numpy(bn_in['rm']))
        bn.running_var.copy_(torch.from_numpy(bn_in['rv']))
    x = torch.from_numpy(bn_in['x'][rows]).requires_grad_()
    y = bn.train()(x)
    (y * torch.from_numpy(bn_in['g'][rows])).sum().backward()
    out['bn_' + name] = {'y': y.detach(), 'dx': x.grad,
                         'dscale': bn.weight.grad, 'dbias': bn.bias.grad,
                         'rm': bn.running_mean.clone(),
                         'rv': bn.running_var.clone()}

region, txt, labels, valid = inp['min']
rows = slice(2 * rank, 2 * rank + 2)
r = torch.from_numpy(region[rows]).requires_grad_()
loss = region_text_contrastive_loss(
    r, torch.from_numpy(txt[rows]), torch.from_numpy(labels[rows]),
    torch.from_numpy(valid[rows]), group=mesh.group)
loss.backward()
out['min'] = {'loss': float(loss), 'grad': r.grad}
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


@pytest.fixture(scope='module')
def ranks(weights, tmp_path_factory):
    """Start both ranks, then hand out a function that waits for them and
    returns rank 0's and rank 1's results."""
    tmp = tmp_path_factory.mktemp('ddp')
    cases = {}
    for case, kw in CASES.items():
        batch, text = _batch(case)
        cases[case] = (dict(kw, max_objects=M, batch_size=B,
                            output_dir=str(tmp / case)), _size(case),
                       _dtype(case), batch, text)
    torch.save({'weights': weights[0], 'cases': cases, 'lr': LR,
                'graph_cases': GRAPH_CASES, 'graph_ema': GRAPH_EMA,
                'bn': _bn_inputs(),
                'bn_splits': BN_SPLITS, 'min': _min_inputs()},
               tmp / 'inputs.pt')
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    rdv = f'file://{tmp}/rendezvous'
    procs = [subprocess.Popen(
        [sys.executable, '-c', WORKER, str(r), rdv, str(tmp)], env=env,
        cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
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
                        for r in range(2)})
        return got[0], got[1]

    yield results
    for p in procs:
        p.kill()


def _single_step(sd, case, tmp):
    """The port's 1-process step (or trainer epoch) on the global batch."""
    cfg = _cfg(_size(case), output_dir=str(tmp), **CASES[case])
    model = YOLOCLIP(cfg.model)
    model.load_state_dict(sd)
    model = model.to(_dtype(case))
    state = ts.TrainState(model, ts.make_optimizer(cfg, model.parameters()))
    ts.set_learning_rate(state, LR)
    batch, text = _batch(case)
    if case == 'ragged_vocab':
        trainer = YOLOCLIPTrainer(model, StubTextEncoder(), cfg, state=state,
                                  device='cpu')
        trainer._schedule = lambda count: LR
        parts = trainer.train_epoch([batch], 1)
    else:
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        tb['images'] = tb['images'].to(_dtype(case))
        parts = ts.make_train_step(cfg)(
            state, tb, torch.from_numpy(text).to(_dtype(case)))
        parts = {k: float(v) for k, v in parts.items()}
    return parts, model


def _rel_l2(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def test_two_rank_step_matches_jax_sharded_step(weights, ranks):
    """JAX's sharded step over a 2-device data mesh, compat objective."""
    sd, variables = weights
    jcfg = JTrainingConfig(model=JModelConfig(image_size=(SIZE, SIZE)),
                           max_objects=M, batch_size=B, optimizer_type='SGD')
    model = JYOLOCLIP(jcfg.model)
    tx = jts.make_optimizer(jcfg)
    # the sharded step donates its state: work on copies
    params = jax.tree_util.tree_map(jnp.array, variables['params'])
    p0 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree_util.tree_map(
                               jnp.array, variables['batch_stats']),
                           opt_state=tx.init(params), tx=tx,
                           apply_fn=model.apply)
    state = jts.set_learning_rate(state, JAX_SGD_LR)
    mesh = jax_create_mesh(n_data=2, n_model=1)
    batch, text = _batch(JAX_CASE)
    with mesh:
        state = replicate_state(state, mesh)
        new, jparts = jax_sharded_step(jcfg, mesh)(state)(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(text))
    got = ranks()[0][JAX_CASE]
    for k in ('loss', 'contrastive_loss', 'iou_loss', 'dfl_loss'):
        w = float(jparts[k])
        assert abs(got['parts'][k] - w) <= JAX_LOSS_RTOL * max(abs(w),
                                                               1e-12), k
    p1 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                new.params)
    jgrads = jax.tree_util.tree_map(lambda a, b: (a - b) / JAX_SGD_LR, p0,
                                    p1)
    zeros = jax.tree_util.tree_map(np.zeros_like, variables['batch_stats'])
    want = state_dict_from_jax({'params': jgrads, 'batch_stats': zeros},
                               _cfg().model)
    top = max(float(want[k].norm()) for k in got['grads'])
    checked = 0
    for k, g in got['grads'].items():
        w = want[k].double()
        if float(w.norm()) <= 1e-6 * top:
            assert float(g.norm()) <= 1e-5 * top, k
            continue
        assert _rel_l2(g.double(), w) <= JAX_GRAD_RTOL, k
        checked += 1
    assert checked >= 100
    stats = state_dict_from_jax({'params': {}, 'batch_stats':
                                 new.batch_stats}, _cfg().model)
    n = 0
    for k, w in stats.items():
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(got['state'][k].numpy(), w.numpy(),
                                       rtol=0, atol=JAX_BUF_ATOL, err_msg=k)
            n += 1
    assert n > 50


@pytest.mark.parametrize('case', [c for c in CASES if c != JAX_CASE])
def test_two_rank_step_matches_single_process(weights, ranks, case,
                                               tmp_path):
    want_parts, model = _single_step(weights[0], case, tmp_path)
    r0, r1 = ranks()
    got = r0[case]
    assert got['identical'] and r1[case]['identical']
    assert got['parts'] == r1[case]['parts']
    for k, w in want_parts.items():
        assert abs(got['parts'][k] - w) <= LOSS_RTOL * max(abs(w), 1e-12), (
            k, got['parts'][k], w)
    if case.startswith('empty_rank'):
        assert want_parts['loss'] > 0
    top = max(float(p.grad.norm()) for p in model.parameters())
    for k, p in model.named_parameters():
        if float(p.grad.norm()) > 1e-6 * top:
            assert _rel_l2(got['grads'][k], p.grad) <= GRAD_RTOL, k
        else:
            assert float(got['grads'][k].norm()) <= 1e-5 * top, k
    for k, v in model.state_dict().items():
        if v.is_floating_point():
            np.testing.assert_allclose(got['state'][k].numpy(), v.numpy(),
                                       rtol=0, atol=STATE_ATOL, err_msg=k)


@pytest.mark.parametrize('split', list(BN_SPLITS))
def test_synced_batchnorm_matches_flax_over_global_batch(ranks, split):
    from flax import linen as nn
    v = _bn_inputs()
    fbn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    stats = {'mean': v['rm'], 'var': v['rv']}

    def f(x, scale, bias):
        y, mut = fbn.apply({'params': {'scale': scale, 'bias': bias},
                            'batch_stats': stats}, x,
                           mutable=['batch_stats'])
        return (y * jnp.asarray(v['g'].transpose(0, 2, 3, 1))).sum(), (
            y, mut['batch_stats'])

    x = jnp.asarray(v['x'].transpose(0, 2, 3, 1))
    (_, (y, new)), (dx, dscale, dbias) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(x, v['scale'], v['bias'])
    r0, r1 = (r['bn_' + split] for r in ranks())
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)   # noqa: E731
    np.testing.assert_allclose(torch.cat([r0['y'], r1['y']]).numpy(),
                               nchw(y), rtol=0, atol=1e-5)
    np.testing.assert_allclose(torch.cat([r0['dx'], r1['dx']]).numpy(),
                               nchw(dx), rtol=0, atol=1e-5)
    for r in (r0, r1):
        np.testing.assert_allclose(r['rm'].numpy(), np.asarray(new['mean']),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(r['rv'].numpy(), np.asarray(new['var']),
                                   rtol=0, atol=1e-6)
    # each rank holds its shard's share of the parameter gradients
    np.testing.assert_allclose((r0['dscale'] + r1['dscale']).numpy(),
                               np.asarray(dscale), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((r0['dbias'] + r1['dbias']).numpy(),
                               np.asarray(dbias), rtol=1e-5, atol=1e-5)


def test_contrastive_min_positive_count_is_global(ranks):
    region, text, labels, valid = _min_inputs()
    want, grad = jax.value_and_grad(
        lambda r: jax_contrastive(r, jnp.asarray(text), jnp.asarray(labels),
                                  jnp.asarray(valid)))(jnp.asarray(region))
    r0, r1 = (r['min'] for r in ranks())
    # DDP's mean over the ranks is the global loss and its gradient
    assert abs((r0['loss'] + r1['loss']) / 2 - float(want)) <= 1e-6 * abs(
        float(want))
    np.testing.assert_allclose(
        torch.cat([r0['grad'], r1['grad']]).numpy() / 2, np.asarray(grad),
        rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize('case', GRAPH_CASES)
def test_two_rank_program_matches_eager_ddp_route(ranks, case):
    """Two steps with EMA through the program route and the eager DDP
    route from the same weights and state: bit for bit on both ranks."""
    for r in ranks():
        got = r['graph_' + case]
        assert got['parts'] == got['eager_parts']
        assert got['n'] > 500 and got['differ'] == [], got['differ'][:5]
        assert got['parts'][0] != got['parts'][1]   # the state moved


def test_two_rank_eval_program_matches_eager_eval_step(ranks):
    for r in ranks():
        (parts, preds), (eparts, epreds) = r['graph_clean']['eval']
        assert {k: float(v) for k, v in parts.items()} == {
            k: float(v) for k, v in eparts.items()}
        for k, v in epreds.items():
            assert torch.equal(preds[k], v), k
        assert int((preds['class_ids'] >= 0).sum()) > 0   # NMS kept some


def test_ranks_with_other_keys_raise_on_both(ranks):
    """Rank 0 passes its 2 rows, rank 1 one row: no rank runs the program,
    both raise naming both keys (within the 60 s collective timeout: a
    hang would fail the ranks)."""
    msgs = [r['mismatch'] for r in ranks()]
    for m in msgs:
        assert m is not None and 'different program keys' in m
        assert '(2, 64, 64, 3)' in m and '(1, 64, 64, 3)' in m
        assert 'rank 0:' in m and 'rank 1:' in m


def test_gloo_on_cuda_cannot_be_captured(ranks):
    on_cuda, on_cpu = ranks()[0]['blocker']
    assert 'gloo' in on_cuda and 'cannot capture' in on_cuda
    assert on_cpu is None


def test_one_cell_mesh_step_is_the_single_device_program(weights,
                                                        tmp_path):
    from yoloclip_tpu_torch.inference.program import ProgramCache
    from yoloclip_tpu_torch.parallel.train_step import (
        make_sharded_train_step)
    cfg = _cfg(SMALL, output_dir=str(tmp_path))
    model = YOLOCLIP(cfg.model)
    model.load_state_dict(weights[0])
    state = ts.create_train_state(model, cfg, 'cpu')
    cache = ProgramCache()
    mesh = pmesh.create_mesh(n_data=1, devices=['cpu'])
    step = make_sharded_train_step(cfg, mesh, programs=cache)(state)
    batch, text = _batch('one_cell')
    b = {k: torch.from_numpy(v[:2]) for k, v in batch.items()}
    parts = step(state, b, torch.from_numpy(text[:2]))
    assert cache.count('train_step') == 1 and cache.agreement is None
    assert torch.isfinite(parts['loss'])


# ---------------------------------------------------------------------------
# mesh helpers (mirroring tests/test_multihost.py)
# ---------------------------------------------------------------------------

def test_process_local_indices_cover_and_partition():
    shards = [multihost.process_local_indices(10, process_index=i,
                                              process_count=3)
              for i in range(3)]
    assert sorted(sum(shards, [])) == list(range(10))
    assert shards[0] == [0, 3, 6, 9]
    even = [multihost.process_local_indices(10, process_index=i,
                                            process_count=3, even=True)
            for i in range(3)]
    assert [len(s) for s in even] == [3, 3, 3]
    assert len(set(sum(even, []))) == 9


def test_subset_and_local_batch_size():
    s = multihost.Subset([10, 11, 12, 13, 14], [4, 0, 2])
    assert len(s) == 3 and [s[i] for i in range(3)] == [14, 10, 12]
    assert multihost.local_batch_size(32) == 32   # one process here
    assert multihost.local_batch_size(32, process_count=4) == 8
    with pytest.raises(ValueError, match='divisible'):
        multihost.local_batch_size(33, process_count=2)


def test_batch_sharding_lays_out_micro_batches():
    mesh = pmesh.create_mesh(n_data=2, devices=['cpu', 'cpu'])
    assert mesh.shape == {'data': 2, 'model': 1} and not mesh.multiprocess
    a, b = pmesh.batch_sharding(mesh, 8, accum=2)
    # micro-batch i of both devices together is global rows [4i, 4i + 4)
    assert a.tolist() == [0, 1, 4, 5] and b.tolist() == [2, 3, 6, 7]
    shards = pmesh.shard_batch({'x': np.arange(8), 'p': list('abcdefgh'),
                                'n': 3}, mesh)
    assert [s['x'].tolist() for s in shards] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert shards[1]['p'] == list('efgh') and shards[1]['n'] == 3
    with pytest.raises(ValueError, match='divisible'):
        pmesh.batch_sharding(mesh, 6, accum=2)


def test_model_axis_not_ported():
    """The 'model' axis is ported (tests/test_torch_tp.py): an in-process
    mesh lays its grid out row-major, as JAX's reshape(n_data, n_model),
    and its data axis is the grid's first column."""
    mesh = pmesh.create_mesh(n_data=2, n_model=2,
                             devices=[f'cpu:{i}' for i in range(4)])
    assert mesh.shape == {'data': 2, 'model': 2}
    assert [[d.index for d in row] for row in mesh.devices] == [[0, 1],
                                                                 [2, 3]]
    assert [d.index for d in mesh.local_devices] == [0, 2]
    assert pmesh.create_mesh(n_model=2, devices=['cpu'] * 4).shape == {
        'data': 2, 'model': 2}
    with pytest.raises(ValueError, match='need 2x3 devices'):
        pmesh.create_mesh(n_data=2, n_model=3, devices=['cpu'] * 4)

def test_trainer_mesh_needs_one_process_a_device(tmp_path):
    cfg = _cfg(output_dir=str(tmp_path))
    with pytest.raises(ValueError, match='one process a data-axis device'):
        YOLOCLIPTrainer(YOLOCLIP(cfg.model), StubTextEncoder(), cfg,
                        mesh=pmesh.create_mesh(2, devices=['cpu'] * 2))


def test_make_global_batch_single_process():
    """Degenerate (one process) case of the local-shard helpers, as
    tests/test_multihost.py: arrays on the process's device, scalars
    passed through, text whole."""
    mesh = pmesh.create_mesh(n_data=1, devices=['cpu'])
    local = {'images': np.arange(8 * 4, dtype=np.float32).reshape(8, 4),
             'n': 3}
    g = multihost.make_global_batch(local, mesh)
    assert g['n'] == 3 and isinstance(g['images'], torch.Tensor)
    np.testing.assert_array_equal(g['images'].numpy(), local['images'])
    t = multihost.make_global_text(np.ones((8, 8, 16), np.float32), mesh)
    assert t.shape == (8, 8, 16) and t.device.type == 'cpu'
