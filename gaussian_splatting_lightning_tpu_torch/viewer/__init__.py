"""Local browser GUI for trained scenes (see viewer.html, a copy of the JAX
package's viewer page: a self-contained WebGL2 app reading ``.splat``)."""

from pathlib import Path

VIEWER_HTML = Path(__file__).parent / "viewer.html"
