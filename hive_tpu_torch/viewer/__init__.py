"""Self-contained 3D mesh-video viewer.

Counterpart of ``hive_tpu/viewer``: the player is a single HTML file with a
hand-written WebGL2 glTF-binary renderer (:file:`index.html`, a copy of
``hive_tpu``'s), served with the export folder by a stdlib HTTP server.

Contract: the server exposes the ``webxr_path`` folder;
``http://localhost:8080?video=<name>`` plays ``<name>/fg.glb`` +
``<name>/bg.glb`` + ``<name>/metadata.json``. Foreground nodes are named
``%06d`` per frame index and toggled at ``metadata.fps``; the background
scene is static. A ``X.glb.gz`` sibling at least as new as ``X.glb`` is
sent with ``Content-Encoding: gzip`` to clients that accept gzip.

Usage::

    python -m hive_tpu_torch.viewer --webxr_path <exports> [--port 8080]
"""

from __future__ import annotations

import argparse
import functools
import http.server
import os
from pathlib import Path

VIEWER_HTML = Path(__file__).with_name("index.html")


def _accepts_gzip(accept_encoding: str) -> bool:
    """True when the Accept-Encoding header admits gzip.

    A plain substring test would treat ``gzip;q=0`` — an explicit refusal
    (RFC 9110 §12.5.3) — as acceptance; parse the coding tokens instead.
    """
    for entry in accept_encoding.split(","):
        parts = [p.strip() for p in entry.split(";")]
        if parts[0].lower() not in ("gzip", "*"):
            continue
        q = 1.0
        for param in parts[1:]:
            if param.lower().startswith("q="):
                try:
                    q = float(param[2:])
                except ValueError:
                    q = 0.0
        if q > 0:
            return True
    return False


class _ViewerRequestHandler(http.server.SimpleHTTPRequestHandler):
    """Serves the export folder, with the viewer page at ``/``."""

    def do_GET(self):  # noqa: N802 — http.server API
        path = self.path.split("?", 1)[0]
        if path in ("/", "/index.html"):
            body = VIEWER_HTML.read_bytes()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        # Pre-gzipped siblings (the pipeline's compression stage writes
        # X.glb.gz next to X.glb): ship those bytes with
        # Content-Encoding: gzip when the client accepts it — every browser
        # does, decoding transparently, so the quantized fallback reaches
        # draco-class transfer sizes with no client-side code.
        if not path.endswith(".gz") and _accepts_gzip(
                self.headers.get("Accept-Encoding", "")):
            base_path = self.translate_path(path)
            gz_path = base_path + ".gz"
            try:
                # A sibling older than its base file is stale (out-of-band
                # regeneration) — fall through to the plain bytes rather
                # than silently serving an outdated mesh.
                fresh = (os.path.getmtime(gz_path)
                         >= os.path.getmtime(base_path))
            except OSError:
                fresh = False
            if fresh:
                size = os.path.getsize(gz_path)
                self.send_response(200)
                self.send_header("Content-Type", self.guess_type(base_path))
                self.send_header("Content-Encoding", "gzip")
                self.send_header("Content-Length", str(size))
                self.send_header("Vary", "Accept-Encoding")
                self.end_headers()
                with open(gz_path, "rb") as f:
                    import shutil
                    shutil.copyfileobj(f, self.wfile)
                return
        super().do_GET()

    def log_message(self, fmt, *args):  # quiet: progress floods the console
        pass


def make_server(webxr_path: str, port: int = 8080) -> http.server.ThreadingHTTPServer:
    """Build (without starting) the viewer HTTP server rooted at ``webxr_path``."""
    handler = functools.partial(_ViewerRequestHandler,
                                directory=os.path.abspath(webxr_path))
    return http.server.ThreadingHTTPServer(("0.0.0.0", port), handler)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        "hive_tpu_torch.viewer", description="Serve exported 3D mesh videos "
        "(fg.glb/bg.glb/metadata.json folders) with the in-tree WebGL player.")
    parser.add_argument("--webxr_path", default="webxr",
                        help="Folder holding per-video export subfolders.")
    parser.add_argument("--port", type=int, default=8080)
    args = parser.parse_args(argv)

    server = make_server(args.webxr_path, args.port)
    videos = sorted(p.name for p in Path(args.webxr_path).iterdir()
                    if (p / "metadata.json").exists()) \
        if os.path.isdir(args.webxr_path) else []
    print(f"Serving {args.webxr_path} on http://localhost:{args.port}")
    for name in videos:
        print(f"  http://localhost:{args.port}?video={name}")
    server.serve_forever()


if __name__ == "__main__":
    main()
