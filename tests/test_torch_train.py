"""The port's train step against the JAX package's, at variant 'n', 128 px,
2-4 images, from the same weights (a seeded port init carried to flax with
the JAX package's `convert_reference_state_dict`).

Tolerances, and why:
  * BatchNorm alone in train mode (ROADMAP C5): running mean/var within
    1e-6 of flax's, outputs within 1e-5. The parent's torch rule (unbiased
    variance in the update) is 1/(n-1) off: 14 % of the variance at n = 8.
  * A whole step: loss parts within 3e-5 relative (measured 8.0e-6);
    every gradient tensor whose norm is above 1e-6 of the largest within
    1e-3 relative L2 (measured 1.2e-4 compat, 5.0e-4 topk_center);
    BatchNorm buffers within 2e-5 (measured 4.1e-6). Train-mode BatchNorm
    normalises with batch statistics, so fp32 rounding compounds through
    the layers, and the JAX package's flax BatchNorm computes its variance
    as E[x^2] - E[x]^2, whose cancellation puts its own train-mode outputs
    1.2e-4 (relative, at 64 px) from a float64 evaluation of the same
    weights where the port's sit 1.9e-5 away. At 64 px (4 values a channel
    at the deepest level) the gaps reach 3.7e-3 in gradients, so the step
    runs at 128 px.
  * Parameters after AdamW: the port's step applies exactly optax's
    `adamw` to its own gradients (within 1e-6, absolute and relative).
    Against the JAX step they cannot agree to 1e-6: Adam's first step moves
    every element by lr * g / (|g| + eps), i.e. +-lr, so an element whose
    gradient is within rounding of 0 flips by 2 lr between the packages.
  * AdamW and SGD on identical gradients: within 1e-6 of optax's.
  * EMA and gradient accumulation over two SGD steps (an update of
    lr * g keeps the gradients' rounding at lr times its size): parameters
    and EMA within 1e-6, loss parts 3e-5, buffers 2e-5.
  * bf16: the median relative error of the outputs the losses read
    (boxes, region embeddings) against the package's own fp32 at most 1.5x
    the JAX package's; each loss part within 1 % of the fp32 total. (A
    scalar loss is a poor yardstick for 1.5x: its bf16 deviations partly
    cancel, and on four batches the port's iou_loss moved 2.5x JAX's while
    its box errors were the smaller.) Parameters, gradients, optimizer
    state and EMA stay fp32.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yoloclip_tpu.config import ModelConfig as JModelConfig
from yoloclip_tpu.config import TrainingConfig as JTrainingConfig
from yoloclip_tpu.models.yolo_clip import YOLOCLIP as JYOLOCLIP
from yoloclip_tpu.train import train_state as jts
from yoloclip_tpu.train.assign import anchor_points as janchors
from yoloclip_tpu.train.losses import (combined_loss_clean,
                                       combined_loss_compat)
from yoloclip_tpu.utils.convert import convert_reference_state_dict
from yoloclip_tpu_torch.config import ModelConfig, TrainingConfig
from yoloclip_tpu_torch.models.layers import BatchNorm2d, ConvBlock
from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP, init_weights
from yoloclip_tpu_torch.train import train_state as ts
from yoloclip_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

SIZE, M, C, LR = 128, 10, 8, 1e-4
BUFFERS = ('running_mean', 'running_var', 'num_batches_tracked')
LOSS_RTOL, GRAD_RTOL, BUF_ATOL, PARAM_ATOL = 3e-5, 1e-3, 2e-5, 1e-6


def _cfgs(**kw):
    jm = {k: v for k, v in kw.items() if k in ('dtype',)}
    tkw = {k: v for k, v in kw.items() if k != 'dtype'}
    jcfg = JTrainingConfig(model=JModelConfig(image_size=(SIZE, SIZE), **jm),
                           max_objects=M, **tkw)
    pcfg = TrainingConfig(model=ModelConfig(image_size=(SIZE, SIZE), **jm),
                          max_objects=M, **tkw)
    return jcfg, pcfg


def _batch(B, seed=0):
    rs = np.random.RandomState(seed)
    xy = rs.rand(B, M, 2) * SIZE * 0.7
    wh = rs.rand(B, M, 2) * SIZE * 0.3 + 4
    return ({'images': rs.rand(B, SIZE, SIZE, 3).astype(np.float32),
             'boxes': np.concatenate([xy, xy + wh], -1).astype(np.float32),
             'class_ids': rs.randint(0, 3, (B, M)).astype(np.int32),
             'valid_mask': rs.rand(B, M) > 0.3},
            rs.randn(B, C, 512).astype(np.float32))


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope='module')
def weights():
    """A seeded port init as a torch state dict and as flax variables."""
    cfg = ModelConfig(image_size=(SIZE, SIZE))
    model = YOLOCLIP(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    variables = convert_reference_state_dict(
        sd, JModelConfig(image_size=(SIZE, SIZE)), with_aux_box=False)
    return sd, jax.tree_util.tree_map(jnp.asarray, variables)


def _port_state(sd, pcfg):
    model = YOLOCLIP(pcfg.model)
    model.load_state_dict(sd, strict=True)
    state = ts.create_train_state(model, pcfg, 'cpu')
    ts.set_learning_rate(state, LR)
    return state


def _jax_value_and_grad(jcfg):
    model = JYOLOCLIP(jcfg.model)
    weights = dict(jcfg.loss_weights)
    if jcfg.assigner == 'topk_center':
        anchors, strides = janchors(jcfg.model.strides,
                                    jcfg.model.image_size)
        loss = lambda o, b: combined_loss_clean(
            o, b, weights, anchors, strides, temperature=jcfg.temperature,
            iou_type=jcfg.iou_type, label_smoothing=jcfg.label_smoothing,
            contrastive_type=jcfg.contrastive_type)
    else:
        loss = lambda o, b: combined_loss_compat(
            o, b, weights, temperature=jcfg.temperature,
            iou_type=jcfg.iou_type, label_smoothing=jcfg.label_smoothing)

    @jax.jit
    def vg(params, batch_stats, batch, text):
        def lf(p):
            out, mut = model.apply({'params': p, 'batch_stats': batch_stats},
                                   batch['images'], text, train=True,
                                   mutable=['batch_stats'])
            total, parts = loss(out, batch)
            return total, (parts, mut['batch_stats'])
        return jax.value_and_grad(lf, has_aux=True)(params)
    return vg


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


def _check_parts(got, want):
    for k in want:
        assert _rel(float(got[k]), float(want[k])) <= LOSS_RTOL, (
            k, float(got[k]), float(want[k]))


def _check_grads(model, jgrads, cfg):
    """Every gradient tensor whose norm is above 1e-6 of the largest,
    within GRAD_RTOL relative L2 of the JAX package's; the rest (e.g. the
    heads the compat objective never reaches) below 1e-5 of the largest
    in the port too."""
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jgrads['batch_stats'])
    want = state_dict_from_jax({'params': jgrads['params'],
                                'batch_stats': zeros}, cfg.model)
    grads = dict(model.named_parameters())
    top = max(float(want[k].norm()) for k in grads)
    checked = 0
    for k, p in grads.items():
        w = want[k]
        if float(w.norm()) <= 1e-6 * top:
            assert float(p.grad.norm()) <= 1e-5 * top, k
            continue
        err = float((p.grad - w).norm() / w.norm())
        assert err <= GRAD_RTOL, (k, err)
        checked += 1
    assert checked >= 100


def _check_buffers(model, jax_batch_stats, cfg, atol=BUF_ATOL):
    want = state_dict_from_jax({'params': {}, 'batch_stats':
                                jax_batch_stats}, cfg.model)
    got = model.state_dict()
    n = 0
    for k, w in want.items():
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                       atol=atol, err_msg=k)
            n += 1
    assert n > 50


def _optax_params(sd_before, model, opt_cfg, jcfg, lr, steps_grads):
    """optax's update of the pre-step weights with the port's own
    gradients, as a torch state dict."""
    variables = convert_reference_state_dict(sd_before, jcfg.model,
                                             with_aux_box=False)
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    tx = (optax.adamw(lr, weight_decay=opt_cfg.weight_decay)
          if opt_cfg.optimizer_type.lower() == 'adamw'
          else optax.sgd(lr, momentum=0.9))
    opt = tx.init(params)
    for g in steps_grads:
        gsd = dict(sd_before)
        gsd.update(g)
        gtree = convert_reference_state_dict(gsd, jcfg.model,
                                             with_aux_box=False)['params']
        upd, opt = tx.update(gtree, opt, params)
        params = optax.apply_updates(params, upd)
    return state_dict_from_jax({'params': params,
                                'batch_stats': variables['batch_stats']},
                               jcfg.model)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize('shape,dtype', [((2, 8, 2, 2), torch.float32),
                                         ((3, 16, 5, 4), torch.float32),
                                         ((2, 8, 4, 4), torch.bfloat16)])
def test_batchnorm_train_mode_matches_flax(shape, dtype):
    """ROADMAP C5: train-mode BatchNorm normalises with the biased batch
    statistics and updates its buffers as flax does (0.9 ra + 0.1 stat,
    the BIASED variance, reduced in fp32 for bf16 input)."""
    from flax import linen as nn
    rs = np.random.RandomState(sum(shape))
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    ch = shape[1]
    rm, rv = rs.randn(ch).astype(np.float32), rs.rand(ch).astype(np.float32)
    scale, bias = rs.rand(ch).astype(np.float32) + 0.5, rs.randn(ch).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    fbn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jdt, param_dtype=jnp.float32)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt)
    y, mut = fbn.apply({'params': {'scale': scale, 'bias': bias},
                        'batch_stats': {'mean': rm, 'var': rv}}, xj,
                       mutable=['batch_stats'])
    bn = BatchNorm2d(ch)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(rm))
        bn.running_var.copy_(torch.from_numpy(rv))
    out = bn.train()(torch.from_numpy(x).to(dtype))
    assert out.dtype == dtype
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut['batch_stats']['mean']),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut['batch_stats']['var']),
                               rtol=0, atol=1e-6)
    tol = 1e-5 if dtype == torch.float32 else 5e-2   # bf16 outputs
    np.testing.assert_allclose(
        out.float().permute(0, 2, 3, 1).detach().numpy(),
        np.asarray(y, np.float32), rtol=0, atol=tol)
    # eval mode is nn.BatchNorm2d's
    ref = torch.nn.BatchNorm2d(ch, eps=1e-5).eval()
    ref.load_state_dict(bn.state_dict())
    xe = torch.from_numpy(x)
    assert torch.equal(bn.eval()(xe), ref(xe))


def test_convblock_uses_flax_batchnorm():
    assert isinstance(ConvBlock(4, 8).bn, BatchNorm2d)


@pytest.mark.parametrize('total,warm', [(100, 10), (7, 1), (12, 0),
                                        (1, 1), (40, 39)])
def test_onecycle_schedule_matches_jax(total, warm):
    """Every count, and counts past the end (clamped). The JAX package
    evaluates in fp32, the port in Python floats: equal within fp32
    rounding, relative to the value and, where 1 + cos(pi t) cancels near
    the end of the curve, to the peak lr."""
    got = ts.make_onecycle_schedule(1e-3, total, warm)
    want = jts.make_onecycle_schedule(1e-3, total, warm)
    for count in range(total + 5):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=2e-6, atol=1e-7 * 1e-3)
    assert got(total + 100) == got(total - 1)


@pytest.mark.parametrize('opt', ['AdamW', 'SGD'])
def test_optimizer_matches_optax(opt):
    """Identical gradients through torch's optimizer and optax's for three
    steps with the lr changed in between; decay on every parameter."""
    cfg = TrainingConfig(optimizer_type=opt, weight_decay=1e-2)
    rs = np.random.RandomState(1)
    shapes = {'conv.weight': (4, 3, 3, 3), 'bn.weight': (4,),
              'bn.bias': (4,)}
    init = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    torch_opt = ts.make_optimizer(cfg, list(params.values()))
    tx = optax.inject_hyperparams(
        optax.adamw if opt == 'AdamW' else optax.sgd)(
        learning_rate=1e-3, **({'weight_decay': 1e-2} if opt == 'AdamW'
                               else {'momentum': 0.9}))
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    for step, lr in enumerate((1e-3, 5e-4, 2e-3)):
        g = {k: (rs.randn(*s) * 10 ** -step).astype(np.float32)
             for k, s in shapes.items()}
        for group in torch_opt.param_groups:
            group['lr'] = lr
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        torch_opt.step()
        state.hyperparams['learning_rate'] = jnp.asarray(lr)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
    for k in shapes:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=0, atol=1e-6)


@pytest.mark.parametrize('assigner', ['compat', 'topk_center'])
def test_train_step_matches_jax(weights, assigner):
    """One AdamW step from the same weights (see the module docstring for
    the tolerances)."""
    sd, variables = weights
    jcfg, pcfg = _cfgs(assigner=assigner)
    batch, text = _batch(2)
    (_, (jparts, jstats)), jgrads = _jax_value_and_grad(jcfg)(
        variables['params'], variables['batch_stats'], _jax(batch),
        jnp.asarray(text))

    state = _port_state(sd, pcfg)
    parts = ts.make_train_step(pcfg)(state, _torch(batch),
                                     torch.from_numpy(text))
    assert state.step == 1
    _check_parts(parts, jparts)
    if assigner == 'topk_center':
        assert float(parts['num_fg']) == float(jparts['num_fg']) > 0
    _check_grads(state.model, {'params': jgrads,
                               'batch_stats': variables['batch_stats']},
                 pcfg)
    _check_buffers(state.model, jstats, pcfg)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    want = _optax_params(sd, state.model, pcfg, jcfg, LR, [grads])
    got = state.model.state_dict()
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=PARAM_ATOL, atol=PARAM_ATOL,
                                   err_msg=k)


def test_ema_and_accumulation_match_jax(weights):
    """Two SGD steps with EMA (warmup 2 steps: decays 0.354 and 0.554)
    and gradient accumulation 2 on a batch of 4, against the JAX package's
    jitted step; then its eval step, which must read the EMA parameters
    with the current BatchNorm buffers."""
    sd, variables = weights
    kw = dict(optimizer_type='SGD', ema_decay=0.9, ema_warmup_steps=2,
              grad_accum_steps=2, label_smoothing=0.1)
    jcfg, pcfg = _cfgs(**kw)
    jmodel = JYOLOCLIP(jcfg.model)
    tx = jts.make_optimizer(jcfg)
    params = variables['params']
    jstate = jts.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=variables['batch_stats'], opt_state=tx.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params), tx=tx,
        apply_fn=jmodel.apply)
    jstate = jts.set_learning_rate(jstate, 1e-2)
    jstep = jax.jit(jts.make_train_step(jcfg))
    state = _port_state(sd, pcfg)
    ts.set_learning_rate(state, 1e-2)
    step = ts.make_train_step(pcfg)
    for i in range(2):
        batch, text = _batch(4, seed=10 + i)
        jstate, jparts = jstep(jstate, _jax(batch), jnp.asarray(text))
        parts = step(state, _torch(batch), torch.from_numpy(text))
        _check_parts(parts, jparts)
    assert state.step == int(jstate.step) == 2
    _check_buffers(state.model, jstate.batch_stats, pcfg)
    want = state_dict_from_jax(jstate.variables, pcfg.model)
    want_ema = state_dict_from_jax({'params': jstate.ema_params,
                                    'batch_stats': jstate.batch_stats},
                                   pcfg.model)
    got = state.model.state_dict()
    for k in state.ema:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
        np.testing.assert_allclose(state.ema[k].numpy(),
                                   want_ema[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    assert any(not torch.equal(state.ema[k], got[k]) for k in state.ema)

    # the eval step: EMA parameters + the model's current buffers
    batch, text = _batch(2, seed=20)
    jeval = jax.jit(jts.make_eval_step(jcfg))
    jp, jpred = jeval(jstate, _jax(batch), jnp.asarray(text))
    parts, pred = ts.make_eval_step(pcfg)(state, _torch(batch),
                                          torch.from_numpy(text))
    _check_parts(parts, jp)
    ref = YOLOCLIP(pcfg.model)
    ref.load_state_dict({**got, **state.ema})
    with torch.no_grad():
        out = ref.eval()(torch.from_numpy(batch['images']),
                         torch.from_numpy(text))
    assert torch.equal(pred['boxes'], out['boxes'][:, :M])
    np.testing.assert_allclose(pred['scores'].numpy(),
                               np.asarray(jpred['scores']), rtol=0,
                               atol=1e-4)


def _median_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.median(np.abs(got - want) / (np.abs(want) + 1e-3)))


def test_bf16_step_error_within_jax(weights):
    """bf16 compute with fp32 master weights, on four batches. The outputs
    every loss reads (train-mode boxes and region embeddings): the port's
    median relative error against its own fp32 at most 1.5x the JAX
    package's against its own. Each loss part: within 1 % of the fp32 total
    loss (bf16 keeps 8 bits). Everything the optimizer keeps stays
    fp32."""
    sd, variables = weights
    keys = ('loss', 'contrastive_loss', 'iou_loss')
    fwd = {}
    for dtype in ('float32', 'bfloat16'):
        jcfg, pcfg = _cfgs(dtype=dtype, ema_decay=0.9)
        jmodel = JYOLOCLIP(jcfg.model)
        fwd[dtype] = (pcfg, jax.jit(lambda v, b, t, m=jmodel: m.apply(
            v, b['images'], t, train=True, mutable=['batch_stats'])[0]))
    errs = {'jax': [], 'port': []}
    for seed in range(4):
        batch, text = _batch(2, seed=30 + seed)
        outs, parts = {}, {}
        for dtype, (pcfg, jf) in fwd.items():
            jout = jf(variables, _jax(batch), jnp.asarray(text))
            state = _port_state(sd, pcfg)
            model = state.model.train()
            with torch.no_grad(), torch.autocast(
                    'cpu', torch.bfloat16, enabled=dtype == 'bfloat16'):
                pout = model(torch.from_numpy(batch['images']),
                             torch.from_numpy(text))
            outs[dtype] = (jout, pout)
            state = _port_state(sd, pcfg)
            parts[dtype] = ts.make_train_step(pcfg)(
                state, _torch(batch), torch.from_numpy(text))
        for k in ('boxes', 'obj_embeddings'):
            errs['jax'].append(_median_rel(outs['bfloat16'][0][k],
                                           outs['float32'][0][k]))
            errs['port'].append(_median_rel(
                outs['bfloat16'][1][k].float().numpy(),
                outs['float32'][1][k].numpy()))
        total = float(parts['float32']['loss'])
        for k in keys:
            assert abs(float(parts['bfloat16'][k])
                       - float(parts['float32'][k])) <= 1e-2 * total, (k,
                                                                       seed)
    for e_port, e_jax in zip(errs['port'], errs['jax']):
        assert e_port <= 1.5 * e_jax, errs
    for p in state.model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == p.dtype
    for v in state.ema.values():
        assert v.dtype == torch.float32
    for st in state.optimizer.state.values():
        for v in st.values():
            if torch.is_tensor(v) and v.is_floating_point():
                assert v.dtype == torch.float32
    for k, v in state.model.state_dict().items():
        if v.is_floating_point():
            assert v.dtype == torch.float32, k
