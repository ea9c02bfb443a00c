"""Profile the renderer: trace a few renders and print the top ops by time.

Counterpart of the JAX package's ``scripts/profile_render.py``, on
``torch.profiler`` (``utils/runtime.trace``, which also writes a Chrome
trace): renders the bench fixture's synthetic scene through the chosen route
(optionally with the backward of the training loss) and ranks the traced
ops by their total self time on the card, or on the host with
``--device cpu``. On the card the kernel route's render (or its gradient
under ``--grad``) replays a captured graph (``utils/graph.py``), as the JAX
script jits either; the tiled route runs eagerly.

Usage:
    python -m gaussian_splatting_lightning_tpu_torch.scripts.profile_render \
        [--width 256 --height 192 --splats 100000 --grad] [--impl cuda|xla] \
        [--trace-dir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import tempfile


def main(argv=None):
    """Profile; returns the printed rows as (op name, ms per iteration,
    calls per iteration) and the trace directory."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--height", type=int, default=192)
    parser.add_argument("--splats", type=int, default=100_000)
    parser.add_argument("--max-pairs", type=int, default=1 << 20)
    parser.add_argument("--scale", type=float, default=0.05,
                        help="splat scale; the bench scene uses 0.008")
    parser.add_argument("--impl", default="cuda", choices=["cuda", "xla"],
                        help="cuda: the kernel route; xla: the tiled route")
    parser.add_argument("--grad", action="store_true")
    parser.add_argument("--top", type=int, default=20)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--trace-dir", default=None,
                        help="where the Chrome trace goes (default: a new temp dir)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain versions)")
    args = parser.parse_args(argv)

    import torch
    from torch.autograd import DeviceType

    from gaussian_splatting_lightning_tpu_torch import interop
    from gaussian_splatting_lightning_tpu_torch.ops.common import TilingConfig
    from gaussian_splatting_lightning_tpu_torch.training.loss import photometric_loss
    from gaussian_splatting_lightning_tpu_torch.training.trainer import resolve_rasterizer
    from gaussian_splatting_lightning_tpu_torch.utils import graph
    from gaussian_splatting_lightning_tpu_torch.utils.runtime import trace

    w, h, n = args.width, args.height, args.splats
    scene = interop.synthetic_scene(n, n, scale=args.scale, device=args.device)
    cam = interop.camera(w, h, device=args.device)
    dev = scene.device
    raster = resolve_rasterizer(args.impl)
    cfg = TilingConfig(max_pairs=args.max_pairs)
    target = torch.zeros((3, h, w), device=dev)
    bg = torch.zeros(3, device=dev)
    xs = (scene.params.xyz, scene.get_opacity(), scene.get_scales(),
          scene.get_rotation(), scene.get_features())

    def loss_or_grad(_static, *params):
        leaves = [t.detach().requires_grad_(args.grad) for t in params]
        with torch.set_grad_enabled(args.grad):
            out, _ = raster(*leaves, cam, w, h, bg, scene.active_sh_degree, config=cfg)
            loss, _ = photometric_loss(out.image, target, 0.2)
            if args.grad:
                return torch.autograd.grad(loss, leaves)
            return loss

    cuda = dev.type == "cuda"
    fn = graph.capture(loss_or_grad, name="profile_render") if (
        cuda and args.impl == "cuda") else loss_or_grad

    def run():
        return fn(None, *xs)

    run()  # builds the kernels, warms the allocator; on the card it captures
    if cuda:
        torch.cuda.synchronize()
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="gs_profile_")
    with trace(trace_dir) as prof:
        for _ in range(args.iters):
            run()

    # self time only: an op's total repeats the time of the ops it calls
    if cuda:
        rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    else:
        rows = [(e.key, e.self_cpu_time_total, e.count) for e in prof.key_averages()
                if e.self_cpu_time_total > 0]
    rows = [(k, us / 1e3 / args.iters, c / args.iters) for k, us, c in rows]
    rows.sort(key=lambda r: -r[1])
    where = "device" if cuda else "host (CPU)"
    print(f"total {where} self time: {sum(r[1] for r in rows):.3f} ms/iter "
          f"({args.impl}, {w}x{h}, {n} splats, grad={args.grad}); trace in {trace_dir}")
    print(f"{'ms/iter':>10} {'calls':>7}  op")
    for name, ms, calls in rows[: args.top]:
        print(f"{ms:10.4f} {calls:7.1f}  {name[:110]}")
    return rows[: args.top], trace_dir


if __name__ == "__main__":
    main()
