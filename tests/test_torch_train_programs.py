"""The trainer's train and eval programs and the text tower's encode
program (`inference/program.py`) on the CPU, against the eager bodies and
the JAX package's jitted steps, built as `yoloclip_tpu/train/trainer.py`
and `yoloclip_tpu/text/encoder.py` build them.

On the CPU a program runs its body on its static input buffers, so the
program and the eager body must agree bit for bit: parameters, EMA,
BatchNorm buffers, optimizer moments and loss parts. Against JAX the
tolerances are `tests/test_torch_train.py`'s (variant 'n', 128 px, SGD at
the default rate so that parameters stay within 1e-6: loss parts 3e-5
relative, parameters and EMA 1e-6), except the BatchNorm buffers: 5e-5
after three steps of two micro-batches (six running-stat updates; measured
1.2e-5 compat, 2.8e-5 topk_center, where one step stays within that
file's 2e-5: flax's E[x^2] - E[x]^2 variance drifts with each update, see
its docstring). The eval predictions as there (scores 1e-4), boxes within
1e-4 relative + 1e-3 px, class ids exact.

The program count follows JAX's `_cache_size()` over class buckets 8, 16,
8 (train and eval) and prompt batches of 3, 4, 5, 9 (buckets 4, 4, 8,
16). The JAX train step compiles three times (compat at buckets 8 and 16,
topk_center at 8; about 20 s each), so the compat run's JAX side runs in a
child process, started with the module's first test, while this process
runs the rest; the tests that need it come last.
"""

import copy
import os
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yoloclip_tpu.config import ModelConfig as JModelConfig
from yoloclip_tpu.config import TrainingConfig as JTrainingConfig
from yoloclip_tpu.models.yolo_clip import YOLOCLIP as JYOLOCLIP
from yoloclip_tpu.text.encoder import CLIPTextEncoder as JaxEncoder
from yoloclip_tpu.text.encoder import save_text_tower_params
from yoloclip_tpu.text.model import CLIPTextTransformer as JaxTower
from yoloclip_tpu.train import train_state as jts
from yoloclip_tpu.utils.convert import convert_reference_state_dict
from yoloclip_tpu_torch.config import ModelConfig, TrainingConfig
from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP, init_weights
from yoloclip_tpu_torch.text.encoder import CLIPTextEncoder
from yoloclip_tpu_torch.train import train_state as ts
from yoloclip_tpu_torch.train.trainer import (YOLOCLIPTrainer,
                                              _bucket_classes)
from yoloclip_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, M, B = 128, 10, 4
LOSS_RTOL, BUF_ATOL, PARAM_ATOL, SCORE_ATOL = 3e-5, 5e-5, 1e-6, 1e-4
# per-sample prompt counts of each step's batch: class buckets 8, 16, 8
BUCKETS_8_16_8 = ((3, 8, 5, 4), (6, 9, 3, 16), (8, 4, 7, 3))
BUCKETS_8 = ((3, 8, 5, 4), (6, 2, 3, 8), (8, 4, 7, 3))
KW = dict(optimizer_type='SGD', ema_decay=0.9, ema_warmup_steps=2,
          grad_accum_steps=2, label_smoothing=0.1, max_objects=M,
          max_epochs=3, warmup_epochs=3, eval_conf_threshold=0.0,
          eval_iou_threshold=0.45)
BATCH_KEYS = ('images', 'boxes', 'class_ids', 'valid_mask')

# the compat run's JAX side in a child process: argv = tests dir, output
CHILD = r'''
import sys
import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import torch
sys.path.insert(0, sys.argv[1])
import test_torch_train_programs as t
out = t._jax_run('compat', t.BUCKETS_8_16_8)
out.pop('jstate')
torch.save(out, sys.argv[2])
'''


def _cfgs(size=SIZE, **kw):
    kw = {**KW, **kw}
    return (JTrainingConfig(model=JModelConfig(image_size=(size, size)),
                            **kw),
            TrainingConfig(model=ModelConfig(image_size=(size, size)),
                           **kw))


class StubTextEncoder:
    """Deterministic per-prompt unit rows, no text tower."""

    def __call__(self, prompts):
        rows = []
        for p in prompts:
            v = np.random.RandomState(zlib.crc32(p.encode())).randn(512)
            rows.append(v / np.linalg.norm(v))
        return torch.tensor(np.stack(rows), dtype=torch.float32)


def _batch(seed, counts, size=SIZE):
    """A loader batch: numpy arrays and per-sample prompt lists of the
    given lengths (class ids index them)."""
    rs = np.random.RandomState(seed)
    xy = rs.rand(B, M, 2) * size * 0.7
    wh = rs.rand(B, M, 2) * size * 0.3 + 4
    return {'images': rs.rand(B, size, size, 3).astype(np.float32),
            'boxes': np.concatenate([xy, xy + wh], -1).astype(np.float32),
            'class_ids': rs.randint(0, 3, (B, M)).astype(np.int32),
            'valid_mask': rs.rand(B, M) > 0.3,
            'text_prompts': [[f'thing {seed} {i} {j}' for j in range(n)]
                             for i, n in enumerate(counts)]}


def _text(prompts):
    """The stub's rows zero-padded to the class bucket, (B, Cb, 512)."""
    rows = [StubTextEncoder()(p) for p in prompts]
    out = torch.zeros((len(rows), _bucket_classes(max(map(len, rows))),
                       512))
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(batch[k]) for k in BATCH_KEYS}


def _weights():
    """A seeded port init as a torch state dict and as flax variables."""
    model = YOLOCLIP(ModelConfig(image_size=(SIZE, SIZE)))
    init_weights(model, torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    variables = convert_reference_state_dict(
        sd, JModelConfig(image_size=(SIZE, SIZE)), with_aux_box=False)
    return sd, jax.tree_util.tree_map(jnp.asarray, variables)


def _sched():
    """The trainer's rate in step units for a loader of one batch."""
    return ts.make_onecycle_schedule(TrainingConfig().learning_rate,
                                     KW['max_epochs'], KW['warmup_epochs'])


def _jax_run(assigner, prompts):
    """Three steps of the JAX trainer's jitted step (`jax.jit(
    make_train_step(cfg), donate_argnums=(0,))`) at the trainer's rates:
    each step's loss parts and `_cache_size()`, then the parameters, EMA
    and BatchNorm buffers in the port's layout."""
    jcfg, cfg = _cfgs(assigner=assigner)
    variables = _weights()[1]
    tx = jts.make_optimizer(jcfg)
    jstate = jts.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables['params'],
        batch_stats=variables['batch_stats'],
        opt_state=tx.init(variables['params']),
        ema_params=jax.tree_util.tree_map(jnp.copy, variables['params']),
        tx=tx, apply_fn=JYOLOCLIP(jcfg.model).apply)
    jstep = jax.jit(jts.make_train_step(jcfg), donate_argnums=(0,))
    out = {'parts': [], 'counts': []}
    for i, counts in enumerate(prompts):
        batch = _batch(10 + i, counts)
        jstate = jts.set_learning_rate(jstate, _sched()(i))
        jstate, parts = jstep(jstate, _jax_batch(batch), jnp.asarray(
            _text(batch['text_prompts']).numpy()))
        out['parts'].append({k: float(v) for k, v in parts.items()})
        out['counts'].append(jstep._cache_size())
    out['state'] = state_dict_from_jax(jstate.variables, cfg.model)
    out['ema'] = state_dict_from_jax({'params': jstate.ema_params,
                                      'batch_stats': jstate.batch_stats},
                                     cfg.model)
    out['step'] = int(jstate.step)
    out['jstate'] = jstate
    return out


def _port_run(sd, assigner, prompts, out_dir):
    """The same three steps through the trainer's programs (schedule_units
    'step': a new rate every step) and through the eager `make_train_step`
    on its own copy of the state."""
    _, cfg = _cfgs(assigner=assigner, output_dir=out_dir)
    models = []
    for _ in range(2):
        models.append(YOLOCLIP(cfg.model))
        models[-1].load_state_dict(sd, strict=True)
    trainer = YOLOCLIPTrainer(models[0], StubTextEncoder(), cfg,
                              device='cpu', schedule_units='step')
    eager = ts.create_train_state(models[1], cfg, 'cpu')
    step = ts.make_train_step(cfg)
    out = {'parts': [], 'eager': [], 'counts': [], 'trainer': trainer,
           'eager_state': eager, 'cfg': cfg}
    for i, counts in enumerate(prompts):
        batch = _batch(10 + i, counts)
        text = trainer._encode_batch_text(batch['text_prompts'])
        assert torch.equal(text, _text(batch['text_prompts']))
        out['parts'].append(trainer.train_epoch([batch], 1))
        out['counts'].append(trainer.programs.count('train_step'))
        ts.set_learning_rate(eager, _sched()(i))
        parts = step(eager, trainer._put_batch(batch), text)
        out['eager'].append({k: float(v) for k, v in parts.items()})
    return out


@pytest.fixture(scope='module', autouse=True)
def compat_jax(tmp_path_factory):
    """The child process computing the compat run's JAX side, started
    before the module's first test; yields a function that waits for its
    result."""
    tmp = tmp_path_factory.mktemp('compat_jax')
    proc = subprocess.Popen(
        [sys.executable, '-c', CHILD, os.path.join(REPO, 'tests'),
         str(tmp / 'out.pt')], env=dict(os.environ, PYTHONPATH=REPO),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    got = {}

    def result():
        if not got:
            try:
                log = proc.communicate(timeout=400)[0]
            finally:
                proc.kill()
            assert proc.returncode == 0, log[-4000:]
            got.update(torch.load(tmp / 'out.pt'))
        return got

    yield result
    proc.kill()


@pytest.fixture(scope='module')
def weights():
    return _weights()


@pytest.fixture(scope='module')
def topk_run(weights, tmp_path_factory):
    """The topk_center run, port and JAX, in this process."""
    return (_port_run(weights[0], 'topk_center', BUCKETS_8,
                      str(tmp_path_factory.mktemp('topk'))),
            _jax_run('topk_center', BUCKETS_8))


@pytest.fixture(scope='module')
def compat_run(weights, compat_jax, tmp_path_factory):
    """The compat run (class buckets 8, 16, 8): the port here, JAX in the
    child process."""
    return (_port_run(weights[0], 'compat', BUCKETS_8_16_8,
                      str(tmp_path_factory.mktemp('compat'))),
            compat_jax())


@pytest.fixture(scope='module')
def eval_run(topk_run):
    """The topk_center run's state through evaluate() (the trainer's eval
    program) and the JAX trainer's jitted eval step over three batches of
    class buckets 8, 16, 8: the counts after each, and each JAX result."""
    port, ref = topk_run
    jeval = jax.jit(jts.make_eval_step(_cfgs()[0]))
    out = {'counts': [], 'jax_counts': [], 'jax': [], 'batches': []}
    for i, counts in enumerate(BUCKETS_8_16_8):
        batch = _batch(20 + i, counts)
        metrics = port['trainer'].evaluate([batch])
        assert np.isfinite(metrics['loss'])
        out['counts'].append(port['trainer'].programs.count('eval_step'))
        text = _text(batch['text_prompts'])
        out['jax'].append(jeval(ref['jstate'], _jax_batch(batch),
                                jnp.asarray(text.numpy())))
        out['jax_counts'].append(jeval._cache_size())
        out['batches'].append((batch, text))
    return out


def _assert_states_equal(got: ts.TrainState, want: ts.TrainState):
    """Parameters, BatchNorm buffers, EMA and optimizer state bit-equal."""
    g, w = got.model.state_dict(), want.model.state_dict()
    assert g.keys() == w.keys()
    for k in w:
        assert torch.equal(g[k], w[k]), k
    for k in want.ema:
        assert torch.equal(got.ema[k], want.ema[k]), k
    assert got.step == want.step
    for p, q in zip(got.model.parameters(), want.model.parameters()):
        sg, sw = got.optimizer.state[p], want.optimizer.state[q]
        assert sg.keys() == sw.keys()
        for k in sw:
            assert torch.equal(sg[k], sw[k]), k


def _check_run(port, ref):
    """(a) over one run: the programs bit-equal to the eager step, and
    within tolerance of the JAX jitted step."""
    for got, want, jparts in zip(port['parts'], port['eager'],
                                 ref['parts']):
        for k, v in got.items():
            assert v == want[k], k
            assert abs(v - jparts[k]) <= LOSS_RTOL * max(abs(jparts[k]),
                                                         1e-12), (k, v)
    state = port['trainer'].state
    _assert_states_equal(state, port['eager_state'])
    assert state.step == ref['step'] == 3
    assert any(not torch.equal(state.ema[k], p)
               for k, p in state.model.named_parameters())
    got, n = state.model.state_dict(), 0
    for k, w in ref['state'].items():
        if k.endswith('num_batches_tracked'):
            continue
        atol = (BUF_ATOL if k.endswith(('running_mean', 'running_var'))
                else PARAM_ATOL)
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=atol, err_msg=k)
        n += 1
    assert n > 100
    for k in state.ema:
        np.testing.assert_allclose(state.ema[k].numpy(),
                                   ref['ema'][k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_capturable_sgd_matches_optax():
    """CapturableSGD (the card's SGD: the rate a 0-d tensor, the update as
    foreach ops) against optax's sgd with momentum 0.9 over three steps
    with the rate changed in between."""
    rs = np.random.RandomState(1)
    shapes = {'conv.weight': (4, 3, 3, 3), 'bn.weight': (4,)}
    init = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    rate = torch.tensor(1e-3)
    opt = ts.CapturableSGD(list(params.values()), lr=rate, momentum=0.9)
    state = ts.TrainState(None, opt)
    tx = optax.inject_hyperparams(optax.sgd)(learning_rate=1e-3,
                                             momentum=0.9)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jp)
    for step, lr in enumerate((1e-3, 5e-4, 2e-3)):
        g = {k: (rs.randn(*s) * 10 ** -step).astype(np.float32)
             for k, s in shapes.items()}
        ts.set_learning_rate(state, lr)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        jstate.hyperparams['learning_rate'] = jnp.asarray(lr)
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
    assert opt.param_groups[0]['lr'] is rate
    for k in shapes:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=0, atol=1e-7)


def test_load_keeps_a_tensor_rate(monkeypatch):
    """A capturable optimizer's rate, a 0-d fp32 tensor (the form forced
    here: only CUDA makes it), survives load_optimizer_state as the same
    tensor holding the saved rate, from a checkpoint in the CPU's form (a
    float rate, capturable off, as CPU runs and older trainers save it);
    the capturable flag comes back on and the step counters are fp32 on
    the parameters' device."""
    monkeypatch.setattr(ts, '_capturable', lambda device: True)
    p = torch.nn.Parameter(torch.ones(3))
    saved = torch.optim.AdamW([p], lr=5e-4)
    p.grad = torch.ones(3)
    saved.step()
    q = torch.nn.Parameter(torch.ones(3))
    cfg = TrainingConfig(optimizer_type='AdamW', learning_rate=1e-3)
    state = ts.TrainState(None, ts.make_optimizer(cfg, [q]))
    rate = state.optimizer.param_groups[0]['lr']
    assert isinstance(rate, torch.Tensor)
    ts.load_optimizer_state(state, saved.state_dict())
    group = state.optimizer.param_groups[0]
    assert group['lr'] is rate and group['capturable'] is True
    assert ts.get_learning_rate(state) == float(np.float32(5e-4))
    assert state.optimizer.state[q]['step'].dtype == torch.float32
    assert 'exp_avg' in state.optimizer.state[q]


def test_load_card_checkpoint_on_the_cpu():
    """A checkpoint in the card's form (groups capturable, the rate a 0-d
    fp32 tensor, fp32 step counters) loads into a CPU optimizer in the
    CPU's form (capturable off, a float rate, CPU step counters) and its
    next step equals the step from the same state saved in the CPU's
    form."""
    cfg = TrainingConfig(optimizer_type='AdamW', learning_rate=2.0 ** -11)
    g = torch.Generator().manual_seed(5)
    p = torch.nn.Parameter(torch.randn(3, 4, generator=g))
    grad = torch.randn(3, 4, generator=g)
    src = ts.make_optimizer(cfg, [p])
    p.grad = grad.clone()
    src.step()
    cpu_form = copy.deepcopy(src.state_dict())
    card_form = copy.deepcopy(cpu_form)
    for group in card_form['param_groups']:
        group['capturable'] = True
        group['lr'] = torch.tensor(group['lr'], dtype=torch.float32)
    for st in card_form['state'].values():
        st['step'] = st['step'].to(torch.float32)
    stepped = []
    for saved in (cpu_form, card_form):
        q = torch.nn.Parameter(p.detach().clone())
        state = ts.TrainState(None, ts.make_optimizer(cfg, [q]))
        ts.load_optimizer_state(state, saved)
        group = state.optimizer.param_groups[0]
        assert group['capturable'] is False
        assert isinstance(group['lr'], float)
        assert state.optimizer.state[q]['step'].device.type == 'cpu'
        q.grad = grad.clone()
        state.optimizer.step()
        stepped.append(q.detach())
    assert torch.equal(*stepped)


def test_load_drops_programs(tmp_path):
    """(d) load() drops the programs; the next step through a new program
    equals an eager step from the loaded checkpoint (AdamW, EMA), at
    64 px."""
    _, cfg = _cfgs(64, optimizer_type='AdamW', grad_accum_steps=1,
                   output_dir=str(tmp_path / 'out'))
    model = YOLOCLIP(cfg.model)
    init_weights(model, torch.Generator().manual_seed(3))
    trainer = YOLOCLIPTrainer(model, StubTextEncoder(), cfg, device='cpu',
                              schedule_units='step')
    batches = [_batch(30 + i, (3, 4, 5, 2), 64) for i in range(3)]
    trainer.train_epoch(batches[:2], 1)
    path = str(tmp_path / 'ckpt.pt')
    trainer.save(path)
    trainer.train_epoch(batches[2:], 1)
    assert trainer.programs.count('train_step') == 1
    trainer.load(path)
    assert trainer.programs.count() == 0 and trainer.state.step == 2
    trainer.train_epoch(batches[2:], 1)
    assert trainer.programs.count('train_step') == 1

    other = YOLOCLIP(cfg.model)
    init_weights(other, torch.Generator().manual_seed(4))
    ref = YOLOCLIPTrainer(other, StubTextEncoder(), cfg, device='cpu')
    ref.load(path)
    ts.set_learning_rate(ref.state, trainer._schedule(2))
    batch = batches[2]
    ref._train_step_eager(ref.state, ref._put_batch(batch),
                          ref._encode_batch_text(batch['text_prompts']))
    _assert_states_equal(trainer.state, ref.state)


def _assert_preds_close(got, want, nms):
    want = {k: np.array(v) for k, v in want.items()}
    assert np.array_equal(got['class_ids'].numpy(), want['class_ids'])
    if nms:
        assert int((got['class_ids'] >= 0).sum()) > 0
    np.testing.assert_allclose(got['scores'].numpy(), want['scores'],
                               rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(got['boxes'].numpy(), want['boxes'],
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize('nms', [False, True])
def test_eval_program_matches_eager_and_jax(topk_run, eval_run, nms):
    """(c) The eval program (EMA parameters, current BatchNorm buffers)
    after the topk_center run: bit-equal to its eager body, within
    tolerance of the JAX jitted eval step, with eval_with_nms off and
    on."""
    port, ref = topk_run
    jcfg, cfg = _cfgs(output_dir=port['cfg'].output_dir, eval_with_nms=nms)
    trainer = YOLOCLIPTrainer(None, StubTextEncoder(), cfg,
                              state=port['trainer'].state, device='cpu')
    batch, text = eval_run['batches'][0]
    arrays = trainer._put_batch(batch)
    parts, preds = trainer._eval_step(trainer.state, arrays, text)
    eparts, epreds = trainer._eval_step_eager(trainer.state, arrays, text)
    assert trainer.programs.count('eval_step') == 1
    for k in eparts:
        assert torch.equal(parts[k], eparts[k]), k
    for k in epreds:
        assert torch.equal(preds[k], epreds[k]), k
    if nms:
        jparts, jpreds = jax.jit(jts.make_eval_step(jcfg))(
            ref['jstate'], _jax_batch(batch), jnp.asarray(text.numpy()))
    else:     # the JAX trainer's eval step on this batch
        jparts, jpreds = eval_run['jax'][0]
    for k in jparts:
        assert abs(float(parts[k]) - float(jparts[k])) <= LOSS_RTOL * abs(
            float(jparts[k])), k
    _assert_preds_close(preds, jpreds, nms)


def test_text_program_counts_follow_jax(tmp_path):
    """(b) The encoder's encode programs are built exactly where the JAX
    encoder's `_encode` traces: prompt batches of 3, 4, 5, 9 (buckets 4,
    4, 8, 16); the embeddings agree (atol 1e-5, as
    tests/test_torch_text.py)."""
    params = jax.jit(JaxTower(width=64, layers=2, heads=1,
                              output_dim=512).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 77), jnp.int32))['params']
    tower = str(tmp_path / 'tower.npz')
    save_text_tower_params(jax.tree_util.tree_map(np.asarray, params), tower)
    enc = CLIPTextEncoder(checkpoint_path=tower, device='cpu')
    jenc = JaxEncoder(checkpoint_path=tower)
    counts, jcounts = [], []
    for i, n in enumerate((3, 4, 5, 9)):
        prompts = [f'a photo of thing {i} {j}' for j in range(n)]
        np.testing.assert_allclose(enc(prompts).numpy(),
                                   np.asarray(jenc(prompts)), rtol=0,
                                   atol=1e-5)
        counts.append(enc.programs.count('encode'))
        jcounts.append(jenc._encode._cache_size())
    assert counts == jcounts == [1, 1, 2, 3]


def test_train_program_counts_follow_jax(compat_run, eval_run):
    """(b) The trainer's train and eval programs are built exactly where
    the JAX trainer's jitted `_train_step` and `_eval_step` trace: class
    buckets 8, 16, 8."""
    port, ref = compat_run
    assert port['counts'] == ref['counts'] == [1, 2, 2]
    assert eval_run['counts'] == eval_run['jax_counts'] == [1, 2, 2]


@pytest.mark.parametrize('assigner', ['topk_center', 'compat'])
def test_train_programs_match_eager_and_jax(assigner, request):
    """(a) Three steps with EMA, grad_accum_steps=2 and a new rate every
    step: the trainer's programs bit-equal to the eager step on a copy of
    the state, and within the JAX jitted step's tolerances."""
    _check_run(*request.getfixturevalue(
        {'compat': 'compat_run', 'topk_center': 'topk_run'}[assigner]))
