"""The invertible 1×1's mixing matrix as one-hot products
(``models/decoder.py::mixing_products``) at MiniSpeech's flow width (80
channels, ``Num_Split`` 4): its values bit-equal to the index gather it
replaced, and the weight's gradient bit-equal across two backward passes,
through ``InvertibleConv`` and through ``FlowDecoder.pack_train``."""

import numpy as np
import pytest
import torch

from glow_tts_tpu_torch.models.decoder import FlowDecoder, InvertibleConv
from glow_tts_tpu_torch.models.glow_tts import random_state_dict
from tests.helpers import tiny_config
from tests.torch_port_helpers import port_config

CHANNELS, SPLIT = 80, 4


def gathered(weight, channels, num_split):
    """The index gather the port built the matrix with before."""
    half, s2 = channels // 2, num_split // 2
    idx = np.arange(channels)
    rem = idx % half
    g = torch.as_tensor((idx // half) * s2 + rem % s2)
    m = torch.as_tensor(rem // s2)
    return (weight[..., g[:, None], g[None, :]]
            * (m[:, None] == m[None, :]))


def minispeech_width_config(stack=3):
    cfg = tiny_config(
        Sound={'Mel_Dim': 80, 'Spectrogram_Dim': 65, 'Frame_Length': 64,
               'Frame_Shift': 16, 'Sample_Rate': 1600},
        Decoder={'Stack': stack, 'Num_Squeeze': 1, 'Num_Split': SPLIT,
                 'Affine_Coupling': {
                     'Calc_Channels': 16,
                     'WaveNet': {'Num_Layers': 2, 'Kernel_Size': 5,
                                 'Dropout_Rate': 0.05}}})
    return port_config(cfg)


def invconv(seed):
    module = InvertibleConv(CHANNELS, SPLIT)
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((SPLIT, SPLIT)))
    with torch.no_grad():
        module.weight.copy_(torch.as_tensor(
            q + 0.1 * rng.standard_normal((SPLIT, SPLIT)),
            dtype=torch.float32))
    return module


@pytest.mark.parametrize('inverse', [False, True])
def test_mixing_matrix_is_the_gather_bit_for_bit(inverse):
    module = invconv(1)
    w = (torch.linalg.inv(module.weight) if inverse else module.weight)
    got = module.mixing_matrix(inverse=inverse)
    assert got.shape == (CHANNELS, CHANNELS)
    assert torch.equal(got, gathered(w, CHANNELS, SPLIT))


def test_mixing_weight_gradient_repeats():
    """Frames enough that a gather's accumulating backward varied."""
    module = invconv(2)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((16, 600, CHANNELS)),
                        dtype=torch.float32)
    upstream = torch.as_tensor(rng.standard_normal((16, 600, CHANNELS)),
                               dtype=torch.float32)
    mask = torch.ones(16, 600, 1)
    grads = []
    for _ in range(2):
        module.zero_grad()
        z, logdet = module(x, mask)
        ((z * upstream).sum() + logdet.sum()).backward()
        grads.append(module.weight.grad.clone())
    assert torch.isfinite(grads[0]).all() and grads[0].abs().sum() > 0
    assert torch.equal(grads[0], grads[1])


def test_pack_train_mixing_is_the_gather_and_its_gradient_repeats():
    cfg = minispeech_width_config()
    decoder = FlowDecoder(cfg)
    state = random_state_dict(cfg, 4)
    prefix = 'layer_Dict.Decoder.'
    decoder.load_state_dict({key[len(prefix):]: value
                             for key, value in state.items()
                             if key.startswith(prefix)})
    weights = [step.layers[1].weight for step in decoder.layer_Dict['Flows']]
    mix_t = decoder.pack_train()['mix_t']
    assert mix_t.shape == (cfg.decoder.stack, CHANNELS, CHANNELS)
    expected = gathered(torch.stack(weights), CHANNELS, SPLIT).transpose(1, 2)
    assert torch.equal(mix_t.detach(), expected.detach())
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((8, 600, CHANNELS)),
                        dtype=torch.float32)
    grads = []
    for _ in range(2):
        decoder.zero_grad()
        mix_t = decoder.pack_train()['mix_t']
        torch.einsum('btc,scd->sbtd', x, mix_t).square().sum().backward()
        grads.append(torch.stack([w.grad.clone() for w in weights]))
    assert torch.equal(grads[0], grads[1])
