"""The hand kernels as `torch.library` custom ops, so that tracers see them.

Each kernel module (`similarity.py`, `nms.py`, `int8_conv.py`) registers
its kernel as one op in the `yoloclip` namespace with exactly two
implementations, the CUDA kernel for `cuda` tensors and the plain PyTorch
version for `cpu` tensors, and a fake that gives the outputs' shapes,
dtypes and strides without computing them. No other device has an
implementation, so the op raises there. No op has an autograd formula:
backward through one raises.

`torch.export` (`utils/export.py`) records the op in its graph; the saved
artifact runs the kernel on the card and, once moved to the CPU, the plain
version there.

The public wrappers check their arguments and call the op, except that an
eager call (a plain tensor, gradients off, no compiler tracing) calls the
op's implementation for the device straight: one function either way, so
there is one CUDA code path. The dispatcher costs 5.5-13 us of host time
a call on an H100 80GB HBM3 machine's host, and the int8 graph makes 26
kernel calls a forward: 1-2 % of a bf16 int8 `detect_batch` at bs=32,
which is host-bound (`chip_smoke.py`'s `[export]` dispatch A/B measures
both).
A call with gradients on goes through the op, so backward raises.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

NAMESPACE = 'yoloclip'


class KernelOp:
    """`yoloclip::<name>` with its cpu and cuda implementations and its
    fake. Calling it runs the op, or for an eager call the implementation
    of the first argument's device; for a device with no implementation it
    raises (`label` names the kernel)."""

    def __init__(self, name: str, label: str, schema: str, cpu: Callable,
                 cuda: Callable, fake: Callable):
        self.name = f'{NAMESPACE}::{name}'
        self.label = label
        self.impls: Dict[str, Callable] = {'cpu': cpu, 'cuda': cuda}
        self.op = torch.library.custom_op(self.name, mutates_args=(),
                                          device_types='cpu',
                                          schema=schema)(cpu)
        self.op.register_kernel('cuda', cuda)
        self.op.register_fake(fake)

    def __call__(self, lead: torch.Tensor, *args):
        impl = self.impls.get(lead.device.type)
        if impl is None:   # a meta tensor too: the op would run the fake
            raise RuntimeError(f'no {self.label} kernel for device '
                               f'{lead.device}')
        if (type(lead) is torch.Tensor and not torch.is_grad_enabled()
                and not torch.compiler.is_compiling()):
            return impl(lead, *args)
        return self.op(lead, *args)
