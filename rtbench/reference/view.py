"""The reference's film of a progressive render at some of its pixels.

Traces passes ``0 … passes - 1`` of a render seeded ``seed`` at the
pixels ``pix`` with :mod:`.tracer`, and accumulates them in pass order in
float32, as the program's film does.  Work is done in blocks of passes so
that the grids stay small.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tables as tb
from . import tracer as tr


def film_at(inputs_tables, camera, seed: int, pix, passes: int,
            snapshot: int, device, dtype=torch.float32, block: int = 256):
    """``{"color_sum" [n, 3], "samples" [n], "misses" [n], "image" [n, 4]
    (uint8 after ``snapshot`` passes), "bounces" (mean bounces a path
    reached)}`` at pixels ``pix`` (numpy int64) after ``passes`` passes."""
    scene = tb.load(inputs_tables, device, dtype)
    cam = tb.camera(camera, scene.width, scene.height, device, dtype)
    clusters = tr.scene_clusters(scene)
    matf = tr.material_matrix(scene.mats)
    n_px = scene.width * scene.height
    pix_t = torch.as_tensor(pix, device=device)
    px = (pix_t % scene.width).repeat(block)
    py = (pix_t // scene.width).repeat(block)
    m = len(pix)
    color_sum = np.zeros((m, 3), np.float32)
    samples = np.zeros(m, np.float32)
    misses = np.zeros(m, np.float32)
    image = None
    reached, paths = 0, 0
    for k0 in range(0, passes, block):
        kn = min(block, passes - k0)
        draws = [tr.pass_draws(seed, k, n_px, scene.recursion + 1, pix_t,
                               device, dtype) for k in range(k0, k0 + kn)]
        jitter = torch.cat([j for j, _ in draws])
        raw = torch.cat([r for _, r in draws], dim=2)
        o, d = tr.camera_rays(cam, px[:kn * m], py[:kn * m], jitter)
        with torch.no_grad():
            color, miss, hops = tr.trace(scene, o, d, tr.preprocess(raw),
                                         matf, clusters)
        color = torch.stack(color, 1).float()
        contrib = torch.where(miss[:, None], 0.0, color)
        contrib = contrib.reshape(kn, m, 3).cpu().numpy()
        hit = (~miss).reshape(kn, m).cpu().numpy().astype(np.float32)
        miss_np = miss.reshape(kn, m).cpu().numpy().astype(np.float32)
        reached += int(hops.sum())
        paths += hops.numel()
        for j in range(kn):
            color_sum = color_sum + contrib[j]
            samples = samples + hit[j]
            misses = misses + miss_np[j]
            if k0 + j + 1 == snapshot:
                image = image_of(scene, color_sum, samples, misses)
    return {"color_sum": color_sum, "samples": samples, "misses": misses,
            "image": image, "bounces": reached / max(paths, 1)}


def image_of(scene, color_sum, samples, misses):
    """The tonemapped uint8 pixels of film sums (host arrays), computed
    on the scene's device as the program computes its image."""
    dev = scene.background.device

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)
    return tr.tonemap_uint8(
        t(color_sum), t(samples), t(misses), scene.background.float(),
        scene.background_alpha.float()).cpu().numpy()
