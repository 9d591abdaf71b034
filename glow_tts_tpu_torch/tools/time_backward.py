"""Time and check the backward flow's kernels alone on one NVIDIA GPU: the
measuring script behind the variants of ``csrc/flow_train_bwd.cu`` that
``PERF.md`` compares (run it on two trees in one call to compare them).

    python3 -m glow_tts_tpu_torch.tools.time_backward [passes,passes,...]

from the repository's root (it borrows ``chip_smoke.py``'s problem and
timing helpers).  At the shipped width and the training shape (B = 32, 512
squeezed frames, the synthetic batch's ragged lengths, dropout 0.05) it
prints, for each number of TF32 passes asked for (default ``3,1``): the
worst gradient error against autograd of the plain version, the backward's
time per flow step, and the two GEMMs alone (the k-tap conv's activation
and weight gradient, and the 1×1 res/skip conv's) with every frame valid
and with the batch's lengths, beside their error against an f64 product.
"""

import os
import sys

import torch


def main(argv):
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from glow_tts_tpu_torch import (TrainCollater, batch_to_device,
                                    load_config, random_state_dict)
    from glow_tts_tpu_torch.ops import coupling_grad as cg
    from glow_tts_tpu_torch.ops import cuda_build
    from glow_tts_tpu_torch.text import Tokenizer
    if not torch.cuda.is_available():
        sys.exit('time_backward: no CUDA device')
    variants = [int(v) for v in (argv[0] if argv else '3,1').split(',')]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda', 0)
    print(cs.card_line())
    cg.load_train_forward_library()
    cg.load_train_backward_library()
    for line in cuda_build.ptxas_report('flow_train_bwd.cu'):
        if 'gemm' in line:
            print(line)

    config = load_config(cs.CONFIG)
    batch = batch_to_device(
        TrainCollater(config, Tokenizer())(
            cs.synthetic_items(config, cs.SEED + 10)), device)
    model = cs.train_model(random_state_dict(config, cs.SEED), config, device)
    model.data_dependent_init(batch['mels'], batch['mel_lengths'])
    x, mask, weights = cs.stack_problem(model, batch, config)
    del model
    gen = torch.Generator().manual_seed(cs.SEED + 5)
    dz = torch.randn(x.shape, generator=gen).to(device)
    dld = (0.5 + torch.rand(x.shape[0], generator=gen)).to(device)
    steps = weights['w_in'].shape[0]

    def leaves():
        return (x.clone().requires_grad_(),
                {key: value.clone().requires_grad_()
                 for key, value in weights.items()})

    def gradients(fn):
        xl, wl = leaves()
        z, ld = fn(xl, mask, wl, seed=cs.SEED + 6, dropout_rate=cs.FLOW_RATE)
        (torch.sum(z * dz) + torch.sum(ld * dld)).backward()
        torch.cuda.synchronize()
        return {'x': xl.grad, **{key: leaf.grad for key, leaf in wl.items()}}

    def backward_ms(fn):
        xl, wl = leaves()
        z, ld = fn(xl, mask, wl, seed=cs.SEED, dropout_rate=cs.FLOW_RATE)
        return cs.cuda_ms(lambda: torch.autograd.grad(
            (z, ld), [xl, *wl.values()], (dz, dld), retain_graph=True),
            5, 1) / steps

    ref = gradients(cg.flow_stack_train_reference)
    for passes in variants:
        got = gradients(cs.forced_route('store', passes))
        errs = {key: cs.rel_err(got[key], value)
                for key, value in ref.items() if key != 'ld_const'}
        print(f'passes={passes}: worst gradient rel err '
              f'{max(errs.values()):.3e} '
              + ', '.join(f'd{key} {err:.1e}' for key, err in errs.items()))
    runs = [(route, passes, backward_ms(cs.forced_route(route, passes)))
            for route in ('store', 'recompute')
            for passes in variants + variants[::-1]]
    for route in ('store', 'recompute'):
        for passes in variants:
            ms = [t for r, p, t in runs if (r, p) == (route, passes)]
            print(f'backward per flow step, route {route!r}, '
                  f'passes={passes}: {sum(ms) / len(ms):.4f} ms')

    b, t, ch, k = 32, 512, 192, 5
    gen = torch.Generator().manual_seed(cs.SEED + 12)
    dpre = torch.randn((b, t, 2 * ch), generator=gen).to(device)
    xin = torch.randn((b, t, ch), generator=gen).to(device)
    w_in = (torch.randn((k, ch, 2 * ch), generator=gen) * .03).to(device)
    w_rs = (torch.randn((1, ch, 2 * ch), generator=gen) * .03).to(device)
    pad = (k - 1) // 2
    for name, m in (('all frames valid', torch.ones_like(mask)),
                    ('the batch\'s lengths', mask)):
        dm, xm = dpre * m, xin * m
        padded = torch.nn.functional.pad(dm, (0, 0, pad, pad)).double()
        exact = sum(padded[:, 2 * pad - tap: 2 * pad - tap + t]
                    @ w_in[tap].double().T for tap in range(k)) * m
        for passes in variants:
            times = [cs.cuda_ms(fn, 20) for fn in (
                lambda: cg._dgrad_product(dm, w_in, m, passes),
                lambda: cg._wgrad_product(xm, dm, m, k, passes),
                lambda: cg._dgrad_product(dm, w_rs, m, passes),
                lambda: cg._wgrad_product(xm, dm, m, 1, passes))]
            err = cs.rel_err(cg._dgrad_product(dm, w_in, m, passes).double(),
                             exact)
            print(f'{name}, passes={passes}: k-tap dgrad {times[0]:.4f} ms '
                  f'(rel err vs f64 {err:.2e}), k-tap wgrad + reduction '
                  f'{times[1]:.4f} ms, 1x1 dgrad (K=384, N=192) '
                  f'{times[2]:.4f} ms, 1x1 wgrad (K=192, N=384) '
                  f'{times[3]:.4f} ms')


if __name__ == '__main__':
    main(sys.argv[1:])
