"""A plain PyTorch 3D Gaussian Splatting training step, written from the paper.

The benchmark's reference: it imports nothing of the program under test and
takes nothing the program made. It follows Kerbl et al. 2023 ("3D Gaussian
Splatting for Real-Time Radiance Field Rendering") and the reference
rasterizer's rules that the port states as its semantics:

- projection: row-vector view and full projection matrices; a splat is
  visible when its view-space z > 0.2, its dilated 2D covariance has a
  non-zero determinant and it is alive; the EWA Jacobian clamps x/z and y/z
  to 1.3 tan(fov); the 2D covariance is dilated by 0.3 px;
- a pixel (x, y) sits at integer coordinates; a splat reaches the pixels of
  the 16 px blocks its 3-sigma rect covers (the rect truncated toward zero);
- alpha = min(0.99, opacity exp(-q/2)); an evaluation with alpha <= 1/255
  is skipped; a splat adds alpha T c while the transmittance T before it is
  above 1e-4; the background is weighted by the product over every splat;
- SH colours up to the active degree, + 0.5, clamped at 0;
- loss 0.8 L1 + 0.2 (1 - SSIM), SSIM with an 11-tap Gaussian window of
  sigma 1.5 and zero padding;
- Adam per parameter group (eps 1e-15) with the paper's learning rates, the
  position's decaying exponentially from 1.6e-4 to 1.6e-6 times the scene
  extent over 30k steps.

Compositing runs over (splat, 16 px block) pairs sorted by depth, a group of
blocks at a time, so that the memory of one group is bounded; the gradient
is taken group by group against the loss's gradient of the image, then
through the projection by autograd. Every tensor is in ``dtype`` (float32;
the precision control runs it in bfloat16).

A configuration names its plain reference (``"reference"``, by default this
module), and the harness (``cell.py``, ``faults.py``) uses nothing of it but
this interface, which another reference provides alike:

- ``LEAVES``: the names of the raw parameters, the program's as well;
- ``W_SSIM``: the SSIM term's weight in the loss;
- ``project(p, alive, cam, width, height, degree)`` -> a record with
  ``p_pix`` (N, 2), ``reach`` (N,) in px and ``visible`` (N,) bool, which
  the pair budget reads, and whatever ``render`` takes;
- ``block_rect(p_pix, radius, grid_x, grid_y, block)`` -> each splat's
  half-open block ranges (x0, x1, y0, y1), for the pair budget;
- ``render(projected, width, height, background, pixel_rows=None)`` ->
  (image, pairs, contributing evaluations), the last for the work counts:
  with ``pixel_rows`` (first, end), multiples of 32, only those of the
  pixels in these rows (a mesh rank's band);
- ``train(p, alive, steps, width, height, degree, first_step, extent)`` ->
  (step records with ``loss`` and ``grads``, the parameters after each
  step, the statistics ``max_radius``, ``grad_sum`` and ``count`` after the
  first step, each element's first step with a non-zero gradient), as
  ``train`` below documents.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

BLOCK = 16
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
NEAR_Z = 0.2
DILATION = 0.3
C1, C2 = 0.01 ** 2, 0.03 ** 2
SSIM_WINDOW, SSIM_SIGMA = 11, 1.5
W_SSIM = 0.2
LEAVES = ("xyz", "features_dc", "features_rest", "opacity", "scales", "quats")
# (pixel, pair) evaluations of one group of blocks: bounds the memory of
# what autograd keeps of a group (about ten tensors of this many elements)
GROUP_EVALS = 1 << 24

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


@dataclass(frozen=True)
class Adam:
    """The paper's learning rates (configs/train_gs.yaml of the reference)."""

    xyz_init: float = 1.6e-4
    xyz_final: float = 1.6e-6
    xyz_max_steps: int = 30_000
    features_dc: float = 2.5e-3
    features_rest: float = 2.5e-3 / 20.0
    opacity: float = 0.025
    scales: float = 5e-3
    quats: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-15

    def lr(self, leaf: str, step: int, extent: float) -> float:
        if leaf != "xyz":
            return getattr(self, leaf)
        t = min(max(step / self.xyz_max_steps, 0.0), 1.0)
        return math.exp(math.log(self.xyz_init * extent) * (1.0 - t)
                        + math.log(self.xyz_final * extent) * t)


def sh_colour(sh, xyz, campos, degree: int):
    """(N, K, 3) coefficients -> (N, 3) colour along the view direction."""
    d = xyz - campos
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    c = SH_C0 * sh[:, 0]
    if degree >= 1:
        c = c - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        c = (c + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
             + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6] + SH_C2[3] * xz * sh[:, 7]
             + SH_C2[4] * (xx - yy) * sh[:, 8])
    if degree >= 3:
        c = (c + SH_C3[0] * y * (3.0 * xx - yy) * sh[:, 9]
             + SH_C3[1] * xy * z * sh[:, 10]
             + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 11]
             + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 12]
             + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 13]
             + SH_C3[5] * z * (xx - yy) * sh[:, 14]
             + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, 15])
    return torch.clamp_min(c + 0.5, 0.0)


@dataclass
class Projected:
    """Per-splat screen quantities of one view."""

    p_pix: torch.Tensor  # (N, 2)
    conic: torch.Tensor  # (N, 3) a, b, c of [[a, b], [b, c]]
    opacity: torch.Tensor  # (N,)
    rgb: torch.Tensor  # (N, 3)
    depth: torch.Tensor  # (N,)
    radius: torch.Tensor  # (N,) 3-sigma radius in px, 0 where not visible
    reach: torch.Tensor  # (N,) radius cut to where alpha can pass 1/255
    visible: torch.Tensor  # (N,) bool


def project(p: dict, alive, cam: dict, width: int, height: int, degree: int,
            ndc_offset=None) -> Projected:
    """Activations, frustum test, EWA covariance, conic, radius and colour.
    ``p`` holds the six raw parameters, ``cam`` the view's matrices."""
    xyz = p["xyz"]
    dt = xyz.dtype
    opacity = torch.sigmoid(p["opacity"]).reshape(-1)
    scale = torch.exp(p["scales"])
    q = p["quats"] / torch.clamp_min(torch.linalg.vector_norm(p["quats"], dim=-1,
                                                              keepdim=True), 1e-12)
    w, x, y, z = q.unbind(-1)
    rot = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)
    m = rot * scale[:, None, :]
    cov3 = m @ m.transpose(1, 2)

    view, full = cam["viewmatrix"].to(dt), cam["projmatrix"].to(dt)
    hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], -1)
    pv = hom @ view
    ph = hom @ full
    ndc = ph[:, :2] / (ph[:, 3:4] + 1e-7)
    if ndc_offset is not None:
        ndc = ndc + ndc_offset
    p_pix = torch.stack([((ndc[:, 0] + 1.0) * width - 1.0) * 0.5,
                         ((ndc[:, 1] + 1.0) * height - 1.0) * 0.5], -1)
    tanx, tany = float(cam["tanfovx"]), float(cam["tanfovy"])
    fx, fy = width * 0.5 / tanx, height * 0.5 / tany
    # a row at or behind the near plane is never visible: its depth is kept
    # out of the Jacobian, whose 1 / z at z = 0 would carry NaN into every
    # gradient through the rows' zero cotangents
    front = pv[:, 2] > NEAR_Z
    zc = torch.where(front, pv[:, 2], torch.ones_like(pv[:, 2]))
    tx = torch.clamp(pv[:, 0] / zc, -1.3 * tanx, 1.3 * tanx) * zc
    ty = torch.clamp(pv[:, 1] / zc, -1.3 * tany, 1.3 * tany) * zc
    zero = torch.zeros_like(zc)
    jac = torch.stack([fx / zc, zero, -fx * tx / (zc * zc),
                       zero, fy / zc, -fy * ty / (zc * zc)], -1).reshape(-1, 2, 3)
    t = jac @ view[:3, :3].T
    cov2 = t @ cov3 @ t.transpose(1, 2)
    a = cov2[:, 0, 0] + DILATION
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + DILATION
    det = a * c - b * b
    visible = front & (det != 0) & alive
    inv = 1.0 / torch.clamp_min(det, 1e-5)
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.where(visible, torch.ceil(3.0 * torch.sqrt(lam)), 0.0)
    # beyond this distance q >= d^2 / lam gives alpha < 1/255; + 1 px for
    # the rect's truncation
    spread = 2.0 * torch.log(torch.clamp_min(opacity / ALPHA_MIN, 1.0)) * lam.clamp_max(1e12)
    reach = torch.minimum(radius, torch.ceil(torch.sqrt(spread)) + 1.0)
    rgb = sh_colour(torch.cat([p["features_dc"], p["features_rest"]], 1), xyz,
                    cam["campos"].to(dt), degree)
    return Projected(p_pix, conic, opacity, rgb, pv[:, 2], radius.detach(),
                     reach.detach(), visible)


def block_rect(p_pix, radius, grid_x: int, grid_y: int, block: int):
    """Half-open block ranges (x0, x1, y0, y1) covered by each splat."""
    def cell(v, hi):
        return torch.clamp(torch.trunc(v / block), 0, hi).long()

    px, py = p_pix[:, 0].float(), p_pix[:, 1].float()
    r = radius.float()
    return (cell(px - r, grid_x), cell(px + r + block - 1, grid_x),
            cell(py - r, grid_y), cell(py + r + block - 1, grid_y))


@dataclass
class Pairs:
    """Depth-sorted (block, splat) pairs of one view."""

    splat: torch.Tensor  # (P,) splat of each pair, blocks in order
    start: torch.Tensor  # (T,) first pair of each block
    count: torch.Tensor  # (T,) pairs of each block
    grid_x: int
    grid_y: int


def make_pairs(pr: Projected, width: int, height: int) -> Pairs:
    gx, gy = -(-width // BLOCK), -(-height // BLOCK)
    x0, x1, y0, y1 = block_rect(pr.p_pix.detach(), pr.reach, gx, gy, BLOCK)
    nx = (x1 - x0).clamp_min(0)
    n = torch.where(pr.visible, nx * (y1 - y0).clamp_min(0), 0)
    dev = n.device
    splat = torch.repeat_interleave(torch.arange(n.shape[0], device=dev), n)
    first = torch.cumsum(n, 0) - n
    k = torch.arange(splat.shape[0], device=dev) - first[splat]
    w = nx[splat]
    block = (y0[splat] + k // w) * gx + x0[splat] + k % w
    rank = torch.empty_like(n)
    rank[torch.argsort(pr.depth.detach().float(), stable=True)] = torch.arange(
        n.shape[0], device=dev)
    order = torch.argsort(block * n.shape[0] + rank[splat])
    count = torch.bincount(block, minlength=gx * gy)
    return Pairs(splat[order], torch.cumsum(count, 0) - count, count, gx, gy)


def _groups(pairs: Pairs):
    """Blocks with pairs, the fullest first, cut into groups of at most
    ``GROUP_EVALS`` padded evaluations."""
    blocks = torch.nonzero(pairs.count).reshape(-1)
    blocks = blocks[torch.argsort(pairs.count[blocks], descending=True)]
    counts = pairs.count[blocks].tolist()
    i, pix = 0, BLOCK * BLOCK
    while i < len(counts):
        g = max(1, GROUP_EVALS // (pix * counts[i]))
        yield blocks[i:i + g], counts[i]
        i += g


def _composite_group(blocks, width_p: int, pairs: Pairs, feats, bg, gx: int):
    """Colour (G, pix, 3) of a group of blocks and each block's evaluations
    kept (alpha above 1/255, T above 1e-4), (G,)."""
    p_pix, conic, opacity, rgb = feats
    dev = p_pix.device
    j = torch.arange(width_p, device=dev)
    valid = j[None] < pairs.count[blocks][:, None]
    idx = torch.clamp(pairs.start[blocks][:, None] + j[None], max=pairs.splat.shape[0] - 1)
    s = pairs.splat[idx]
    dt = p_pix.dtype
    pix = torch.arange(BLOCK * BLOCK, device=dev)
    px = ((blocks % gx) * BLOCK)[:, None] + (pix % BLOCK)[None]
    py = ((blocks // gx) * BLOCK)[:, None] + (pix // BLOCK)[None]
    dx = p_pix[s, 0][:, None, :] - px.to(dt)[:, :, None]
    dy = p_pix[s, 1][:, None, :] - py.to(dt)[:, :, None]
    cs = conic[s]
    q = cs[..., 0][:, None] * dx * dx + 2.0 * cs[..., 1][:, None] * dx * dy \
        + cs[..., 2][:, None] * dy * dy
    alpha = torch.clamp_max(torch.exp(-0.5 * q) * opacity[s][:, None], ALPHA_MAX)
    keep = (alpha > ALPHA_MIN) & valid[:, None, :]
    alpha = torch.where(keep, alpha, 0.0)
    t_in = torch.cumprod(1.0 - alpha, -1)
    t_ex = torch.cat([torch.ones_like(t_in[..., :1]), t_in[..., :-1]], -1)
    live = t_ex > T_MIN
    w = torch.where(live, alpha * t_ex, 0.0)
    colour = w @ rgb[s] + t_in[..., -1:] * bg
    return colour, (keep & live).sum((1, 2))


def _to_image(tiles: torch.Tensor, pairs: Pairs, width: int, height: int):
    """(T, pix, 3) block layout -> (3, H, W)."""
    gx, gy = pairs.grid_x, pairs.grid_y
    img = tiles.reshape(gy, gx, BLOCK, BLOCK, 3).permute(4, 0, 2, 1, 3)
    return img.reshape(3, gy * BLOCK, gx * BLOCK)[:, :height, :width]


def _to_blocks(img: torch.Tensor, pairs: Pairs) -> torch.Tensor:
    """(3, H, W) -> (T, pix, 3), zero outside the image."""
    gx, gy = pairs.grid_x, pairs.grid_y
    pad = F.pad(img, (0, gx * BLOCK - img.shape[2], 0, gy * BLOCK - img.shape[1]))
    return pad.reshape(3, gy, BLOCK, gx, BLOCK).permute(1, 3, 2, 4, 0).reshape(
        gy * gx, BLOCK * BLOCK, 3)


def render(pr: Projected, width: int, height: int, bg, pixel_rows=None):
    """(image (3, H, W), pairs, kept evaluations) without autograd; with
    ``pixel_rows`` (first, end), block multiples, the evaluations kept in
    the blocks of those rows alone."""
    pairs = make_pairs(pr, width, height)
    feats = tuple(x.detach() for x in (pr.p_pix, pr.conic, pr.opacity, pr.rgb))
    bg = bg.to(pr.p_pix.dtype)
    tiles = bg.expand(pairs.count.shape[0], BLOCK * BLOCK, 3).clone()
    kept = 0
    with torch.no_grad():
        for blocks, width_p in _groups(pairs):
            colour, k = _composite_group(blocks, width_p, pairs, feats, bg, pairs.grid_x)
            tiles[blocks] = colour
            if pixel_rows is not None:
                top = blocks // pairs.grid_x * BLOCK
                k = k[(top >= pixel_rows[0]) & (top < pixel_rows[1])]
            kept += int(k.sum())
    return _to_image(tiles, pairs, width, height), pairs, kept


def render_backward(pr: Projected, pairs: Pairs, grad_image, bg):
    """Push the image's gradient into the per-splat screen quantities and on
    through ``pr``'s autograd graph to the parameters."""
    leaves = [x.detach().requires_grad_() for x in (pr.p_pix, pr.conic, pr.opacity, pr.rgb)]
    ct = _to_blocks(grad_image, pairs)
    bg = bg.to(pr.p_pix.dtype)
    for blocks, width_p in _groups(pairs):
        with torch.enable_grad():
            colour, _ = _composite_group(blocks, width_p, pairs, leaves, bg, pairs.grid_x)
        torch.autograd.backward(colour, ct[blocks])
    outs = [pr.p_pix, pr.conic, pr.opacity, pr.rgb]
    grads = [torch.zeros_like(x) if x.grad is None else x.grad for x in leaves]
    torch.autograd.backward(outs, grads)


def _gauss_taps(dtype, device):
    x = torch.arange(SSIM_WINDOW, dtype=torch.float64) - SSIM_WINDOW // 2
    g = torch.exp(-(x * x) / (2.0 * SSIM_SIGMA ** 2))
    return (g / g.sum()).to(dtype=dtype, device=device)


def _blur(x):
    """Separable Gaussian blur of (C, H, W) with zero padding."""
    taps = _gauss_taps(x.dtype, x.device)
    r = SSIM_WINDOW // 2
    c = x.shape[0]
    x = F.conv2d(x[None], taps.reshape(1, 1, -1, 1).expand(c, 1, -1, 1).contiguous(),
                 padding=(r, 0), groups=c)
    x = F.conv2d(x, taps.reshape(1, 1, 1, -1).expand(c, 1, 1, -1).contiguous(),
                 padding=(0, r), groups=c)
    return x[0]


def ssim(x, y):
    """Mean SSIM of two (3, H, W) images, zero-padded. The padded images are
    shifted by each image's mean before the blur and the means added back
    after, which leaves every SSIM term unchanged and keeps the variances'
    digits."""
    cx, cy = x.mean().detach(), y.mean().detach()
    r = SSIM_WINDOW // 2
    xs = F.pad(x, (r, r, r, r)) - cx
    ys = F.pad(y, (r, r, r, r)) - cy
    blurred = _blur(torch.cat([xs, ys, xs * xs, ys * ys, xs * ys]))[:, r:-r, r:-r]
    bx, by, bxx, byy, bxy = blurred.chunk(5)
    mx, my = bx + cx, by + cy
    vx, vy, vxy = bxx - bx * bx, byy - by * by, bxy - bx * by
    s = ((2.0 * mx * my + C1) * (2.0 * vxy + C2)) / (
        (mx * mx + my * my + C1) * (vx + vy + C2))
    return s.mean()


def photometric_loss(image, target):
    return (1.0 - W_SSIM) * (image - target).abs().mean() + W_SSIM * (1.0 - ssim(image, target))


@dataclass
class StepRecord:
    loss: float
    grads: dict  # leaf -> gradient of the step's loss
    screen: torch.Tensor  # (V, N) norm of each view's NDC mean gradient
    radius: torch.Tensor  # (V, N)


def gradients(p: dict, alive, views: list, width: int, height: int, degree: int):
    """Loss (the mean over ``views``), the parameters' gradients and each
    view's screen-space gradient norms. ``views`` holds dicts of the
    view's matrices, ``image`` (3, H, W) and ``background`` (3,)."""
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    n_views = len(views)
    total, screens, radii = 0.0, [], []
    for view in views:
        offset = torch.zeros(alive.shape[0], 2, dtype=p["xyz"].dtype, device=alive.device,
                             requires_grad=True)
        with torch.enable_grad():
            pr = project(leaves, alive, view, width, height, degree, offset)
        image, pairs, _ = render(pr, width, height, view["background"])
        image = image.detach().requires_grad_()
        target = view["image"].to(image.dtype)
        with torch.enable_grad():
            loss = photometric_loss(image, target) / n_views
            (grad_image,) = torch.autograd.grad(loss, image)
        render_backward(pr, pairs, grad_image, view["background"])
        total += float(loss.detach())
        # each view's own loss gradient (the batch mean's times the views)
        screens.append(torch.linalg.vector_norm(offset.grad * n_views, dim=-1))
        radii.append(pr.radius)
    grads = {k: torch.zeros_like(v) if v.grad is None else v.grad for k, v in leaves.items()}
    return StepRecord(total, grads, torch.stack(screens), torch.stack(radii))


def train(p: dict, alive, steps: list, width: int, height: int, degree: int,
          first_step: int, extent: float, adam: Adam = Adam()):
    """Run ``len(steps)`` steps (each a list of views) from the parameters
    ``p`` and fresh Adam moments. Returns the step records, the parameters
    after each step, the densification statistics (max radius, sum of
    screen-space gradient norms, count) after the first step, and for each
    leaf the step (from 0) in which each element's gradient was first
    non-zero, ``len(steps)`` where it never was (uint8). Until that step the
    element's moments are 0 and Adam leaves it exactly where it was."""
    p = {k: v.detach().clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    records, after = [], []
    n = len(steps)
    first_moved = {k: torch.full_like(v, n, dtype=torch.uint8) for k, v in p.items()}
    for i, views in enumerate(steps):
        rec = gradients(p, alive, views, width, height, degree)
        records.append(rec)
        for k, g in rec.grads.items():
            first_moved[k][(first_moved[k] == n) & (g != 0)] = i
        t = i + 1
        bc1, bc2 = 1.0 - adam.beta1 ** t, 1.0 - adam.beta2 ** t
        with torch.no_grad():
            for k in LEAVES:
                g = rec.grads[k]
                m[k] = adam.beta1 * m[k] + (1.0 - adam.beta1) * g
                v2[k] = adam.beta2 * v2[k] + (1.0 - adam.beta2) * g * g
                lr = adam.lr(k, first_step + i, extent)
                p[k] = p[k] - lr * (m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + adam.eps)
        after.append(dict(p))
    first = records[0]
    seen = first.radius > 0
    stats = dict(max_radius=torch.where(seen, first.radius, 0.0).amax(0),
                 grad_sum=torch.where(seen, first.screen, 0.0).sum(0),
                 count=seen.to(first.screen.dtype).sum(0))
    return records, after, stats, first_moved
