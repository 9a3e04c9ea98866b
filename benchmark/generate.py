"""The benchmark's inputs, made on the device from ``--seed``: the data set,
the weights and every random draw a cell hands to the program and to the
reference alike.

* ``intensities``: 28x28 class-template images (four Gaussian blobs a
  class, a random brightness, Gaussian pixel noise, scaled to [0, 1]), the
  same recipe as the program's synthetic MNIST stand-in, drawn on the card.
* ``weights``: every parameter in a few large draws: He-normal linear
  layers, ``N(0, 1/H)`` latent heads, zero biases, ``|K| = init_k``.
* ``train_draws``: an epoch's batch order, binarization uniforms and
  reparameterization noise; ``iwae_noise``: a pass's importance noise.

Each draw has a generator of its own, seeded from (seed, what, index), so a
later draw can be made again alone (``mix``). Nothing here imports the
program.
"""
from __future__ import annotations

import hashlib
import math

import torch

from reference import vae as ref


def mix(seed: int, *tags) -> int:
    """A 63-bit seed for the draw named by ``tags`` under the run's
    ``seed``."""
    text = ":".join(str(t) for t in (seed,) + tags).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, *tags))


def intensities(n: int, side: int, gen, device, classes: int = 10,
                blobs: int = 4):
    """(n, side * side) float32 images in [0, 1]."""
    p = torch.rand((classes, blobs, 5), generator=gen, device=device)
    cx, cy = 0.2 + 0.6 * p[..., 0], 0.2 + 0.6 * p[..., 1]
    sx, sy = 0.05 + 0.15 * p[..., 2], 0.05 + 0.15 * p[..., 3]
    amp = (0.5 + p[..., 4]) * (0.3 + 0.7 * torch.rand(
        (classes, blobs), generator=gen, device=device))
    g = torch.arange(side, device=device, dtype=torch.float32) / side
    yy, xx = g[:, None], g[None, :]
    t = amp[..., None, None] * torch.exp(
        -((xx - cx[..., None, None]) ** 2 / (2 * sx[..., None, None] ** 2)
          + (yy - cy[..., None, None]) ** 2 / (2 * sy[..., None, None] ** 2)))
    templates = t.sum(dim=1).reshape(classes, side * side)
    cls = torch.randint(0, classes, (n,), generator=gen, device=device)
    bright = 0.7 + 0.6 * torch.rand((n, 1), generator=gen, device=device)
    img = templates[cls] * bright + 0.15 * torch.randn(
        (n, side * side), generator=gen, device=device)
    img.clamp_(min=0.0)
    return img / (img.amax(dim=1, keepdim=True) + 1e-9)


def dataset(cfg: dict, seed: int, device):
    """(train, test) intensities of the configuration's data set."""
    gen = generator(device, seed, "data")
    side = int(math.isqrt(cfg["data_dim"]))
    train = intensities(cfg["train_examples"], side, gen, device)
    test = intensities(cfg["test_examples"], side, gen, device)
    return train, test


def weights(cfg: dict, seed: int, device) -> dict:
    """Name -> float32 parameter, in the program's tree order."""
    lats = ref.parse_spec(cfg["spec"])
    D, H = cfg["data_dim"], cfg["h_dim"]
    Z = sum(l.ambient for l in lats)
    shapes = ref.param_shapes(lats, D, H)
    fan_in = {"encoder.layers.0.w": D, "decoder.layers.0.w": Z,
              "decoder.out.w": H}
    drawn = [k for k in shapes if k.split(".")[-1] in ("w", "w_mu", "w_sig")]
    total = sum(math.prod(shapes[k]) for k in drawn)
    flat = torch.randn((total,), generator=generator(device, seed, "weights"),
                       device=device)
    out, off = {}, 0
    for k, shape in shapes.items():
        leaf = k.split(".")[-1]
        if k in drawn:
            size = math.prod(shape)
            scale = (math.sqrt(2.0 / fan_in[k]) if leaf == "w"
                     else 1.0 / math.sqrt(H))
            out[k] = (scale * flat[off:off + size]).reshape(shape)
            off += size
        elif leaf == "c_param":
            out[k] = torch.full(shape, math.log(cfg["init_k"]),
                                device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


def noise(lats, shape, gen, device):
    """(*shape, E) standard noise of the product latent, factor by factor:
    N(0, 1) tangent draws, led for the vMF by its cosine's U[1e-7, 1)."""
    shape = tuple(shape)
    E = sum(l.noise_width for l in lats)
    out = torch.randn(shape + (E,), generator=gen, device=device)
    off = 0
    for l in lats:
        if l.posterior == "vmf":
            out[..., off] = ref.U_MIN + (1.0 - ref.U_MIN) * torch.rand(
                shape, generator=gen, device=device)
        off += l.noise_width
    return out


def train_draws(cfg: dict, traffic: dict, seed: int, epoch: int, device):
    """Epoch ``epoch``'s (perm (S, B) example indices, u_bin (S, B, D)
    binarization uniforms, noise (S, B, E))."""
    lats = ref.parse_spec(cfg["spec"])
    N, B, D = cfg["train_examples"], traffic["batch_size"], cfg["data_dim"]
    S = N // B
    gen = generator(device, seed, "train", epoch)
    perm = torch.randperm(N, generator=gen, device=device)[:S * B]
    u = torch.rand((S, B, D), generator=gen, device=device)
    return perm.reshape(S, B), u, noise(lats, (S, B), gen, device)


def eval_batches(cfg: dict) -> tuple[int, int]:
    """(batches, batch size) of a pass over the test split: the last batch
    padded to the full size."""
    bs = min(cfg["eval_batch_size"], cfg["test_examples"])
    return -(-cfg["test_examples"] // bs), bs


def iwae_noise(cfg: dict, traffic: dict, seed: int, index: int, device):
    """Pass ``index``'s importance noise (batches, n, batch size, E)."""
    lats = ref.parse_spec(cfg["spec"])
    nb, bs = eval_batches(cfg)
    gen = generator(device, seed, "iwae", index)
    return noise(lats, (nb, traffic["samples"], bs), gen, device)
