"""The reference's first steps of a material fit.

Follows the program's train step (``make_train_step(None, Adam)``) from
the same inputs: camera rays from the step's jitter (a generator on the
device seeded ``pass_seed(step_seed, 0)``), path uniforms from
Philox4x32-10 keyed ``pass_seed(step_seed, 1)``, the paths of
:func:`.tracer.trace` with their hits held fixed and their shading
differentiated by autograd, the L2 loss against the target over the whole
image (misses black), and Adam written out by hand (``torch.optim.Adam``'s
update with its defaults, ``foreach`` aside).

The Philox stream is a frozen copy of
``raytracercore_tpu_torch/render/uniforms_kernel.py``
``prepare_uniforms_reference`` (commit 25c2873).
"""

from __future__ import annotations

import torch

from . import tables as tb
from . import tracer as tr

FIELDS = ("emission", "diffuse", "specular", "refraction",
          "refractive_index", "shininess")
BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8

MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b):
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def _philox(ctr, key):
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniforms(seed: int, n: int, bounces: int, device):
    """Raw ``[bounces, 5, n]`` float32 uniforms of path seed ``seed``:
    counter ``(r, b, 0, 0)`` gives u0-u3 of path r, bounce b, counter
    ``(r, b, 1, 0)`` word 0 gives u4; a word maps to ``(w >> 8) · 2^-24``."""
    seed = int(seed) & ((1 << 64) - 1)
    key = (seed & MASK32, seed >> 32)
    r = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    b = torch.arange(bounces, dtype=torch.int64, device=device)[:, None]
    r, b = torch.broadcast_tensors(r, b)
    zero = torch.zeros_like(r)
    w = _philox((r, b, zero, zero), key)
    w4 = _philox((r, b, torch.ones_like(r), zero), key)[0]
    return torch.stack([(x >> 8).to(torch.float32) * 2.0 ** -24
                        for x in (*w, w4)], dim=1)


def steps(tables, camera, target, step_seeds, lr: float, device,
          dtype=torch.float32, first_grad_step: int = 0, fault=None):
    """Run ``len(step_seeds)`` steps from the scene's own materials:
    ``{"losses": [...], "grads": {field: first step's gradient},
    "params": {field: after the last step}, "start": {field: before},
    "bounces": mean bounces a path reached}``.

    ``fault`` plants a fault, for the readings the limits are set from:
    "half" leaves out the second half of the pixels and takes the mean
    over the rest; "altered" adds 1 to the first pixel's colour where the
    paths produce it."""
    scene = tb.load(tables, device, dtype)
    h, w = scene.height, scene.width
    cam = tb.camera(camera, w, h, device, dtype)
    clusters = tr.scene_clusters(scene)
    leaves = {f: scene.mats[f].detach().clone().requires_grad_(True)
              for f in FIELDS}
    start = {f: v.detach().clone() for f, v in leaves.items()}
    m = {f: torch.zeros_like(v) for f, v in leaves.items()}
    v2 = {f: torch.zeros_like(v) for f, v in leaves.items()}
    pix = torch.arange(h * w, device=device)
    px, py = pix % w, pix // w
    tgt = target.to(dtype).reshape(h * w, 3)
    out = {"losses": [], "grads": None, "bounces": 0.0}
    for s, seed in enumerate(step_seeds):
        gen = torch.Generator(device=device)
        gen.manual_seed(tr.pass_seed(seed, 0))
        jitter = torch.rand((h * w, 4), generator=gen,
                            device=device).to(dtype)
        raw = uniforms(tr.pass_seed(seed, 1), h * w, scene.recursion + 1,
                       device).to(dtype)
        o, d = tr.camera_rays(cam, px, py, jitter)
        mats = dict(scene.mats, **leaves)
        color, miss, hops = tr.trace(scene, o, d, tr.preprocess(raw),
                                     tr.material_matrix(mats), clusters)
        img = torch.where(miss[:, None], 0.0, torch.stack(color, 1))
        if fault == "altered":
            img = torch.cat([img[:1] + 1.0, img[1:]])
        if fault == "half":
            half = h * w // 2
            loss = torch.sum((img[:half] - tgt[:half]) ** 2) / (half * 3)
        else:
            loss = torch.sum((img - tgt) ** 2) / (h * w * 3)
        grads = torch.autograd.grad(loss, [leaves[f] for f in FIELDS])
        out["losses"].append(float(loss.detach()))
        out["bounces"] += float(hops.float().mean()) / len(step_seeds)
        if s == first_grad_step:
            out["grads"] = {f: g.detach().clone()
                            for f, g in zip(FIELDS, grads)}
        t = s + 1
        with torch.no_grad():
            for f, g in zip(FIELDS, grads):
                m[f].mul_(BETA1).add_(g, alpha=1 - BETA1)
                v2[f].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                bc1 = 1 - BETA1 ** t
                bc2_sqrt = (1 - BETA2 ** t) ** 0.5
                denom = (v2[f].sqrt() / bc2_sqrt).add_(ADAM_EPS)
                leaves[f].addcdiv_(m[f], denom, value=-lr / bc1)
        del color, img, loss, grads
    out["params"] = {f: v.detach().clone() for f, v in leaves.items()}
    out["start"] = start
    return out
