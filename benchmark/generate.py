"""The benchmark's inputs, made on the device from ``--seed``: the data set,
the weights and every random draw a cell hands to the program and to the
reference alike.

* ``intensities``: class-template images of the configuration's
  ``data_shape`` (four Gaussian blobs a class, each weighted a channel, a
  random brightness, Gaussian pixel noise, scaled to [0, 1]; ``(H, W, C)``
  in the program's NHWC layout, ``(D,)`` a square single-channel image
  flattened), the same recipe as the program's synthetic stand-ins, drawn
  on the card.
* ``weights``: every parameter in a few large draws, at the scales the
  configuration's reference module gives (``init``).
* ``train_draws``: an epoch's batch order, binarization uniforms (where the
  configuration binarizes) and reparameterization noise; ``iwae_noise``: a
  pass's importance noise.

The model-facing draws take the configuration's reference module (``ref``,
``reference/__init__.py``'s contract). Each draw has a generator of its
own, seeded from (seed, what, index), so a later draw can be made again
alone (``mix``). Nothing here imports the program.
"""
from __future__ import annotations

import hashlib
import math

import torch


def mix(seed: int, *tags) -> int:
    """A 63-bit seed for the draw named by ``tags`` under the run's
    ``seed``."""
    text = ":".join(str(t) for t in (seed,) + tags).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, *tags))


def image_dims(data_shape) -> tuple[int, int, int]:
    """(H, W, C) of a data shape: ``(H, W, C)``, or ``(D,)`` a square
    one-channel image of D pixels."""
    if len(data_shape) == 3:
        return tuple(data_shape)
    side = math.isqrt(data_shape[0])
    if len(data_shape) != 1 or side * side != data_shape[0]:
        raise ValueError(f"data_shape {data_shape}: neither (H, W, C) nor "
                         "a square image's (D,)")
    return side, side, 1


def intensities(n: int, data_shape, gen, device, classes: int = 10,
                blobs: int = 4):
    """(n, *data_shape) float32 images in [0, 1], channels last."""
    H, W, C = image_dims(data_shape)
    p = torch.rand((classes, blobs, 5), generator=gen, device=device)
    cx, cy = 0.2 + 0.6 * p[..., 0], 0.2 + 0.6 * p[..., 1]
    sx, sy = 0.05 + 0.15 * p[..., 2], 0.05 + 0.15 * p[..., 3]
    amp = (0.5 + p[..., 4, None]) * (0.3 + 0.7 * torch.rand(
        (classes, blobs, C), generator=gen, device=device))
    yy = (torch.arange(H, device=device, dtype=torch.float32) / H)[:, None]
    xx = (torch.arange(W, device=device, dtype=torch.float32) / W)[None, :]
    t = amp[:, :, None, None, :] * torch.exp(
        -((xx - cx[..., None, None]) ** 2 / (2 * sx[..., None, None] ** 2)
          + (yy - cy[..., None, None]) ** 2 / (2 * sy[..., None, None] ** 2))
    )[..., None]
    templates = t.sum(dim=1).reshape(classes, H * W * C)
    cls = torch.randint(0, classes, (n,), generator=gen, device=device)
    bright = 0.7 + 0.6 * torch.rand((n, 1), generator=gen, device=device)
    img = templates[cls] * bright + 0.15 * torch.randn(
        (n, H * W * C), generator=gen, device=device)
    img.clamp_(min=0.0)
    img = img / (img.amax(dim=1, keepdim=True) + 1e-9)
    return img.reshape((n,) + tuple(data_shape))


def dataset(cfg: dict, seed: int, device):
    """(train, test) intensities of the configuration's data set."""
    gen = generator(device, seed, "data")
    train = intensities(cfg["train_examples"], cfg["data_shape"], gen, device)
    test = intensities(cfg["test_examples"], cfg["data_shape"], gen, device)
    return train, test


def weights(ref, cfg: dict, seed: int, device) -> dict:
    """Name -> float32 parameter, in the program's tree order: the leaves
    ``ref.init`` draws from one flat N(0, 1) draw, each at its scale, the
    rest filled."""
    lats = ref.parse_spec(cfg["spec"])
    shapes = ref.param_shapes(lats, cfg)
    init = ref.init(lats, cfg)
    total = sum(math.prod(shapes[k]) for k, (kind, _) in init.items()
                if kind == "normal")
    flat = torch.randn((total,), generator=generator(device, seed, "weights"),
                       device=device)
    out, off = {}, 0
    for k, shape in shapes.items():
        kind, value = init[k]
        if kind == "normal":
            size = math.prod(shape)
            out[k] = (value * flat[off:off + size]).reshape(shape)
            off += size
        else:
            out[k] = torch.full(shape, value, device=device)
    return out


def noise(ref, lats, shape, gen, device):
    """(*shape, E) standard noise of the product latent, factor by factor:
    N(0, 1) tangent draws, led for the vMF by its cosine's U[1e-7, 1). A
    reference module with a ``noise`` of its own (posteriors with other
    draws: rejection proposals) draws in its place, from ``gen``."""
    if hasattr(ref, "noise"):
        return ref.noise(lats, tuple(shape), gen, device)
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


def train_draws(ref, cfg: dict, traffic: dict, seed: int, epoch: int,
                device):
    """Epoch ``epoch``'s (perm (S, B) example indices, u_bin (S, B,
    *data_shape) binarization uniforms, None where the configuration does
    not binarize, noise (S, B, E))."""
    lats = ref.parse_spec(cfg["spec"])
    N, B = cfg["train_examples"], traffic["batch_size"]
    S = N // B
    gen = generator(device, seed, "train", epoch)
    perm = torch.randperm(N, generator=gen, device=device)[:S * B]
    u = (torch.rand((S, B) + tuple(cfg["data_shape"]), generator=gen,
                    device=device) if cfg["binarize"] else None)
    return perm.reshape(S, B), u, noise(ref, lats, (S, B), gen, device)


def eval_batches(cfg: dict) -> tuple[int, int]:
    """(batches, batch size) of a pass over the test split: the last batch
    padded to the full size."""
    bs = min(cfg["eval_batch_size"], cfg["test_examples"])
    return -(-cfg["test_examples"] // bs), bs


def iwae_noise(ref, cfg: dict, traffic: dict, seed: int, index: int,
               device):
    """Pass ``index``'s importance noise (batches, n, batch size, E)."""
    lats = ref.parse_spec(cfg["spec"])
    nb, bs = eval_batches(cfg)
    gen = generator(device, seed, "iwae", index)
    return noise(ref, lats, (nb, traffic["samples"], bs), gen, device)
