"""Model FLOPs of one training step, counted from the reference's shapes alone.

One microbatch of the reference runs forward and backward on the ``meta`` device
under ``torch.utils.flop_counter.FlopCounterMode``: every convolution and matrix
product counts once forward, and in backward once for the weight gradient of a
module that trains and once for the input gradient where autograd needs it (up
to a trained theta); frozen modules count their forward alone. No recompute and
no optimizer arithmetic enter the count, so it reads the same work whatever
implements it. Times the microbatches of a step.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import step as ref_step
from benchmark.reference.precision import Precision


def step_flops(spec, reference):
    dev = torch.device('meta')
    recon, atms = ref_step.build(spec, reference, dev)
    B, V = spec['batch_size'], spec['n_views']
    D = tuple(spec['hires_fov_vox'])
    eye = torch.eye(4)
    micro = {'label': torch.zeros((B,) + D, dtype=torch.int64, device=dev),
             'nii_affine': eye.expand(B, 4, 4).to(dev),
             'view_affines': eye.expand(V, B, 4, 4).to(dev)}
    counter = FlopCounterMode(display=False)
    with counter:
        loss = ref_step.micro_loss(spec, reference, recon, atms, micro,
                                   torch.Generator().manual_seed(0), Precision())
        loss.backward()
    return float(counter.get_total_flops()) * spec['num_grad_accum_steps']
