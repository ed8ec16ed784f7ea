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
        unsplit forward, float64: within 1e-9;
      - `make_sharded_inference` as the 'sharded_inference' program
        (rows over data, classes over model) against JAX's
        `make_sharded_inference` on its 2x2 mesh (ids exact, scores 1e-5)
        and the port's unsharded forward (1e-6); its later call, its
        eager route and a class_mask input; a rank with another global
        batch raises `ProgramKeyMismatch` on every rank;
      - `spatialize_detector` over the four processes (128 px, 4 blocks
        of 32 rows): `detect()` split 4 ways and `detect_batch()` with
        batch over data x height over model, as the detector's programs,
        against JAX's spatialized detector and the port's in-process
        split (test_torch_spatial.py's bounds), every rank returning the
        same detections, the eager route equal;
      - both program routes on a CUDA device over gloo raise before
        touching it, and `DetectionServer(spatial=True)` refuses a mesh
        across processes.
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

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.config import InferenceConfig as JInferenceConfig
from yoloclip_tpu.config import ModelConfig as JModelConfig
from yoloclip_tpu.inference.detector import YOLOCLIPDetector as JDetector
from yoloclip_tpu.config import TrainingConfig as JTrainingConfig
from yoloclip_tpu.models.yolo_clip import YOLOCLIP as JYOLOCLIP
from yoloclip_tpu.parallel.mesh import create_mesh as jax_create_mesh
from yoloclip_tpu.parallel.spatial import (spatialize_detector as
                                           jax_spatialize)
from yoloclip_tpu.parallel.train_step import (make_sharded_inference as
                                              jax_sharded_inference,
                                              make_sharded_train_step as
                                              jax_sharded_step,
                                              place_text as jax_place_text,
                                              replicate_state)
from yoloclip_tpu.text.encoder import save_text_tower_params
from yoloclip_tpu.text.model import CLIPTextTransformer as JaxTower
from yoloclip_tpu.train import train_state as jts
from yoloclip_tpu.utils.convert import convert_reference_state_dict
from yoloclip_tpu_torch.config import (InferenceConfig, ModelConfig,
                                       TrainingConfig)
from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP, init_weights
from yoloclip_tpu_torch.ops import quantize
from yoloclip_tpu_torch.ops.kernels import similarity as sim
from yoloclip_tpu_torch.parallel import collectives as col
from yoloclip_tpu_torch.parallel.mesh import create_mesh
from yoloclip_tpu_torch.parallel.spatial import spatialize_detector
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
SPLIT = 128                 # the split detector's canvas: 4 blocks of 32
NAMES = ['cat', 'dog', 'person']
# tests/test_torch_spatial.py's bounds (the JAX tests'): ids and counts
# exact, scores 1e-4, boxes 1 px for detect() (int boxes), 0.5 px for
# detect_batch()
SPLIT_SCORE_ATOL, DETECT_BOX_PX, BATCH_BOX_PX = 1e-4, 1, 0.5


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

# the class-sharded forward as a program: rows over data, classes over model
from yoloclip_tpu_torch.config import InferenceConfig
from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
from yoloclip_tpu_torch.inference.program import ProgramKeyMismatch
from yoloclip_tpu_torch.inference.server import DetectionServer
from yoloclip_tpu_torch.parallel.mesh import Mesh
from yoloclip_tpu_torch.parallel.spatial import spatialize_detector
from yoloclip_tpu_torch.parallel.train_step import (make_sharded_inference,
                                                    sharded_programs)
pick = lambda o: {k: o[k] for k in ('scores', 'class_ids', 'boxes')}
model = YOLOCLIP(cfg)
model.load_state_dict(inp['weights'])
model = model.eval()
images, text, mask = inp['infer']
cache = sharded_programs(mesh)
run = make_sharded_inference(model, mesh, programs=cache)
res = {'first': pick(run(images, text)[0]),
       'again': pick(run(images, text)[0]),
       'masked': pick(run(images, text, class_mask=mask)[0]),
       'eager': pick(make_sharded_inference(model, mesh, eager=True)(
           images, text)[0])}
try:   # rank 3 passes another global batch: no rank runs a program
    run(images[:2] if rank == 3 else images, text)
    res['mismatch'] = None
except ProgramKeyMismatch as e:
    res['mismatch'] = str(e)
res['count'] = cache.count('sharded_inference')
out['infer'] = res

# the program routes on a CUDA device over gloo (ranks sharing a card)
on_card = Mesh([['cuda:0'] * 2] * 2, data_group=mesh.data_group,
               model_group=mesh.model_group, host_group=mesh.host_group,
               host_data_group=mesh.host_data_group,
               host_model_group=mesh.host_model_group)
sp = inp['spatial_det']
det = YOLOCLIPDetector(InferenceConfig(model=ModelConfig(
    image_size=(sp['size'], sp['size'])), conf_threshold=-10.0, nms_topk=64,
    max_detections=16), vocab_path=sp['vocab'], text_checkpoint=sp['tower'],
    state_dict=sp['state'], device='cpu')
refused = {}
for name, fn in (('infer', lambda: make_sharded_inference(model, on_card)),
                 ('spatial', lambda: spatialize_detector(det, on_card))):
    try:
        fn()
        refused[name] = None
    except RuntimeError as e:
        refused[name] = str(e)
out['refused'] = refused

# the split detector across the four processes: detect() 4 ways, then
# detect_batch with batch over data x height over model
spatialize_detector(det, mesh)
res = {'detect': [det.detect(sp['frame']) for _ in range(2)]}
spatialize_detector(det, mesh, batch_axis='data', height_axis='model')
res['batch'] = [{k: v.clone() for k, v in det.detect_batch(
    sp['frames']).items()} for _ in range(2)]
res['programs'] = {n: det.programs.count(n)
                   for n in ('canvas', 'detect_batch')}
spatialize_detector(det, mesh, eager=True)
res['detect_eager'] = det.detect(sp['frame'])
spatialize_detector(det, mesh, batch_axis='data', height_axis='model',
                    eager=True)
res['batch_eager'] = det.detect_batch(sp['frames'])
res['eager_programs'] = det.programs.count()
try:
    DetectionServer(det, max_batch=4, mesh=mesh, spatial=True)
    res['server'] = None
except ValueError as e:
    res['server'] = str(e)
out['split'] = res
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


def _infer_inputs():
    """4 images of 64 px, 8 classes and a class mask."""
    rs = np.random.RandomState(31)
    return (torch.from_numpy(rs.rand(B, SIZE, SIZE, 3).astype(np.float32)),
            torch.from_numpy(rs.randn(C, 512).astype(np.float32)),
            torch.tensor([True, False, True, True, False, True, True,
                          False]))


def _frame():
    return (np.random.RandomState(7).rand(100, 150, 3) * 255).astype(
        np.uint8)


def _frames():
    return (np.random.RandomState(11).rand(4, SPLIT, SPLIT, 3)
            * 255).astype(np.uint8)


@pytest.fixture(scope='module')
def split_files(tmp_path_factory):
    """The split detector's weights at SPLIT px (4 blocks of 32 rows): a
    seeded port init and its flax variables; its JSON vocabulary and
    miniature text tower."""
    tmp = tmp_path_factory.mktemp('split')
    model = YOLOCLIP(ModelConfig(image_size=(SPLIT, SPLIT)))
    init_weights(model, torch.Generator().manual_seed(2))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    variables = jax.tree_util.tree_map(
        jnp.asarray, convert_reference_state_dict(
            state, JModelConfig(image_size=(SPLIT, SPLIT)),
            with_aux_box=False))
    rng = np.random.RandomState(0)
    vocab = rng.randn(len(NAMES), 512)
    vocab /= np.linalg.norm(vocab, axis=-1, keepdims=True)
    path = str(tmp / 'vocab.json')
    with open(path, 'w') as f:
        json.dump({n: v.tolist() for n, v in zip(NAMES, vocab)}, f)
    params = JaxTower(width=64, layers=1, heads=1, output_dim=512).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 77), jnp.int32))['params']
    npz = str(tmp / 'tower.npz')
    save_text_tower_params(jax.tree_util.tree_map(np.asarray, params), npz)
    return variables, {'vocab': path, 'tower': npz, 'size': SPLIT}, state


@pytest.fixture(scope='module')
def ranks(weights, split_files, tmp_path_factory):
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
                'spatial': _spatial_inputs(), 'infer': _infer_inputs(),
                'spatial_det': dict(split_files[1], state=split_files[2],
                                    frame=_frame(), frames=_frames())},
               tmp / 'inputs.pt')
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


def _rows(got, key):
    """The whole batch's outputs of the 2x2 class-sharded forward: data
    row 0 from rank 0, row 1 from rank 2 (each row's model ranks hold the
    same outputs)."""
    for r, twin in ((0, 1), (2, 3)):
        for k in got[r]['infer'][key]:
            assert torch.equal(got[r]['infer'][key][k],
                               got[twin]['infer'][key][k]), (r, key, k)
    return {k: torch.cat([got[r]['infer'][key][k] for r in (0, 2)])
            for k in got[0]['infer'][key]}


def _unsharded(weights, **kw):
    images, text, _ = _infer_inputs()
    model = YOLOCLIP(ModelConfig(image_size=(SIZE, SIZE)))
    model.load_state_dict(weights[0])
    with torch.inference_mode():
        return model.eval()(images, text, **kw)


def test_sharded_inference_program_matches_jax(weights, ranks):
    """`make_sharded_inference` over the 2x2 grid of processes as the
    'sharded_inference' program (on the CPU its body over gloo) against
    JAX's `make_sharded_inference` on its 2x2 mesh and the port's
    unsharded forward: ids exact, scores 1e-5 / 1e-6
    (`test_vocab_parallel_inference_matches_jax`'s bounds)."""
    images, text, _ = _infer_inputs()
    jmesh = jax_create_mesh(n_data=2, n_model=2)
    jout = jax_sharded_inference(JYOLOCLIP(JModelConfig(
        image_size=(SIZE, SIZE))).apply, jmesh)(
            weights[1], jnp.asarray(images.numpy()),
            jnp.asarray(text.numpy()))
    one = _unsharded(weights)
    got = _rows(ranks(), 'first')
    np.testing.assert_array_equal(got['class_ids'].numpy(),
                                  np.asarray(jout['class_ids']))
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(jout['scores']), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got['boxes'].numpy(),
                               np.asarray(jout['boxes']), rtol=0, atol=1e-3)
    assert torch.equal(got['class_ids'], one['class_ids'])
    np.testing.assert_allclose(got['scores'].numpy(), one['scores'].numpy(),
                               rtol=0, atol=1e-6)


def test_sharded_inference_program_matches_eager_route(weights, ranks):
    """The program's later call and the eager route (eager=True) equal its
    first call bit for bit; a class_mask goes in as an input (another
    program of the same key) and matches the unsharded masked forward."""
    got = ranks()
    first = _rows(got, 'first')
    for key in ('again', 'eager'):
        rows = _rows(got, key)
        for k in first:
            assert torch.equal(rows[k], first[k]), (key, k)
    assert {got[r]['infer']['count'] for r in range(4)} == {2}
    _, _, mask = _infer_inputs()
    one = _unsharded(weights, class_mask=mask)
    masked = _rows(got, 'masked')
    assert torch.equal(masked['class_ids'], one['class_ids'])
    assert bool(mask[masked['class_ids'].long()].all())
    np.testing.assert_allclose(masked['scores'].numpy(),
                               one['scores'].numpy(), rtol=0, atol=1e-6)


def test_sharded_inference_other_shape_raises_on_every_rank(ranks):
    """Rank 3 passes a global batch of 2 where the others pass 4: every
    rank raises ProgramKeyMismatch naming both shapes, and no program is
    built for it."""
    for r, res in ranks().items():
        m = res['infer']['mismatch']
        assert m is not None and 'different program keys' in m, r
        assert '(4, 64, 64, 3)' in m and '(2, 64, 64, 3)' in m, r


def test_program_routes_over_gloo_on_cuda_raise(ranks):
    """`make_sharded_inference` and `spatialize_detector` over gloo ranks
    on a CUDA device raise (gloo's collectives cannot be captured) before
    touching the device; eager=True is the route there."""
    for r, res in ranks().items():
        for name, msg in res['refused'].items():
            assert msg is not None and 'gloo' in msg, (r, name)
            assert 'cannot capture' in msg and 'eager=True' in msg, (r, name)


def _split_port(split_files):
    _, files, state = split_files
    return YOLOCLIPDetector(
        InferenceConfig(model=ModelConfig(image_size=(SPLIT, SPLIT)),
                        conf_threshold=-10.0, nms_topk=64,
                        max_detections=16),
        vocab_path=files['vocab'], text_checkpoint=files['tower'],
        state_dict=state, device='cpu')


def _split_jax(split_files):
    variables, files, _ = split_files
    return JDetector(vocab_path=files['vocab'], variables=variables,
                     text_checkpoint=files['tower'],
                     config=JInferenceConfig(
                         model=JModelConfig(image_size=(SPLIT, SPLIT)),
                         conf_threshold=-10.0, nms_topk=64,
                         max_detections=16))


def _same_dets(got, want, box_tol=DETECT_BOX_PX):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a['class_id'] == b['class_id']
        assert a['score'] == pytest.approx(b['score'], abs=SPLIT_SCORE_ATOL)
        np.testing.assert_allclose(a['box'], b['box'], atol=box_tol)


def test_spatial_detect_program_matches_jax(split_files, ranks):
    """detect() after `spatialize_detector` over the 2x2 grid of processes:
    the canvas program splits the frame 4 ways over the world (1 block of
    32 rows each); against JAX's spatialized detect() and the port's
    in-process split, within test_torch_spatial.py's bounds; every rank
    returns the same detections, the program's later call and the eager
    route equal to its first."""
    frame = _frame()
    jdet = _split_jax(split_files)
    jax_spatialize(jdet, jax_create_mesh(n_data=2, n_model=2))
    want = jdet.detect(frame)
    det = _split_port(split_files)
    spatialize_detector(det, create_mesh(2, 2, devices=['cpu'] * 4))
    inproc = det.detect(frame)
    got = ranks()
    first = got[0]['split']['detect'][0]
    for r in range(4):
        res = got[r]['split']
        assert res['detect'] == [first, first] == [res['detect_eager']] * 2
        assert res['programs']['canvas'] == 1, r
        assert res['eager_programs'] == 0, r
    _same_dets(first, want)
    _same_dets(first, inproc)


def test_spatial_detect_batch_program_matches_jax(split_files, ranks):
    """detect_batch() with batch over 'data' x height over 'model' across
    the four processes (each returns the whole batch's detections) against
    JAX's spatialized detect_batch and the port's in-process split: ids
    and counts exact, scores 1e-4, boxes 0.5 px."""
    frames = _frames()
    jdet = _split_jax(split_files)
    jax_spatialize(jdet, jax_create_mesh(n_data=2, n_model=2),
                   batch_axis='data', height_axis='model')
    want = jax.tree_util.tree_map(np.asarray,
                                  dict(jdet.detect_batch(frames)))
    det = _split_port(split_files)
    spatialize_detector(det, create_mesh(2, 2, devices=['cpu'] * 4),
                        batch_axis='data', height_axis='model')
    inproc = {k: v.numpy() for k, v in det.detect_batch(frames).items()}
    got = ranks()
    first = got[0]['split']['batch'][0]
    for r in range(4):
        res = got[r]['split']
        assert res['programs']['detect_batch'] == 1, r
        for out in res['batch'] + [res['batch_eager']]:
            for k in first:
                assert torch.equal(out[k], first[k]), (r, k)
    first = {k: v.numpy() for k, v in first.items()}
    for ref in (want, inproc):
        np.testing.assert_array_equal(first['count'], ref['count'])
        np.testing.assert_array_equal(first['class_ids'], ref['class_ids'])
        np.testing.assert_allclose(first['scores'], ref['scores'],
                                   atol=SPLIT_SCORE_ATOL)
        np.testing.assert_allclose(first['boxes'], ref['boxes'],
                                   atol=BATCH_BOX_PX)


def test_spatial_server_refuses_a_mesh_across_processes(ranks):
    """DetectionServer(spatial=True) serves from one process, as JAX's
    does: a mesh across processes raises ValueError saying so."""
    for r, res in ranks().items():
        assert 'one process' in res['split']['server'], r


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
