"""Interactive browser viewer for a trained checkpoint.

Counterpart of the JAX package's ``scripts/view.py``: converts a PLY
checkpoint to the ``.splat`` interchange in memory (or reads a ``.splat``)
and serves the self-contained WebGL2 viewer (``viewer/viewer.html``) on
localhost. No network access, no JS dependencies.

Usage:
    python -m gaussian_splatting_lightning_tpu_torch.scripts.view \
        runs/.../point_cloud-final.ply [--port 8642] [--device cuda]
then open http://127.0.0.1:8642/ (drag = orbit, wheel = zoom,
shift-drag = pan).
"""

from __future__ import annotations

import argparse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def make_handler(html: bytes, splat: bytes):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path in ("/", "/index.html"):
                body, ctype = html, "text/html; charset=utf-8"
            elif self.path == "/scene.splat":
                body, ctype = splat, "application/octet-stream"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def make_server(checkpoint: str, host: str = "127.0.0.1", port: int = 8642,
                device="cuda"):
    """(server, splat byte count): the viewer's HTTP server for a ``.ply`` or
    ``.splat`` file, bound but not yet serving (``serve_forever``; port 0
    picks a free port)."""
    from gaussian_splatting_lightning_tpu_torch.viewer import VIEWER_HTML

    if checkpoint.endswith(".splat"):
        with open(checkpoint, "rb") as f:
            splat = f.read()
    else:
        from gaussian_splatting_lightning_tpu_torch.models import load_ply
        from gaussian_splatting_lightning_tpu_torch.models.splat_export import (
            scene_to_splat_bytes,
        )

        splat = scene_to_splat_bytes(load_ply(checkpoint, device=device))
    server = ThreadingHTTPServer((host, port), make_handler(VIEWER_HTML.read_bytes(), splat))
    return server, len(splat)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint", help="trained .ply (or .splat) file")
    parser.add_argument("--port", type=int, default=8642)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--device", default="cuda",
                        help="where a .ply checkpoint is loaded (cuda or cpu)")
    args = parser.parse_args(argv)

    server, n_bytes = make_server(args.checkpoint, args.host, args.port, args.device)
    host, port = server.server_address[:2]
    print(
        f"serving {n_bytes // 32} splats ({n_bytes / 1e6:.1f} MB) at "
        f"http://{host}:{port}/  (ctrl-c to stop)"
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
