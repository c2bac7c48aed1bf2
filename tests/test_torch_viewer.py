"""hive_tpu_torch's viewer, form interface and ``--webxr_run_server``
against hive_tpu's.

Both servers serve one export folder; for each request of
tests/test_viewer.py (the page, the exported files, a missing file, gzip
siblings accepted, refused with ``q=0``, absent, and stale) the status,
headers (but ``Date``) and bytes are equal. The player page is a
byte-equal copy, and every glTF feature the port's writer emits is named
in it. The form interface collects the same fields and builds a pipeline
with the same options. ``--webxr_run_server`` starts the port's viewer,
and mirrors hive_tpu's schemeless-URL fault (``--webxr_url localhost:9000``
parses to no port, so the server binds 8080).
"""

import dataclasses
import enum
import gzip
import http.client
import json
import os
import struct
import threading
from http.server import ThreadingHTTPServer
from unittest import mock

import numpy as np
import pytest

import hive_tpu.interface as jax_interface
import hive_tpu.options as jax_options
import hive_tpu.viewer as jax_viewer
import hive_tpu_torch.interface as interface
import hive_tpu_torch.viewer as viewer
from hive_tpu_torch.meshing.gltf import export_scene, write_gzip_sibling
from hive_tpu_torch.meshing.mesh import Scene, TriangleMesh


@pytest.fixture()
def export_dir(tmp_path):
    """tests/test_viewer.py's export folder, written by the port: a
    vertex-coloured ``bg.glb`` with a gzip sibling, a textured ``fg.glb``
    and ``metadata.json``."""
    video = tmp_path / "exports" / "seq01"
    video.mkdir(parents=True)

    tri = TriangleMesh(
        vertices=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
        faces=np.array([[0, 1, 2]], np.int64),
        vertex_colors=np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8))
    bg = Scene()
    bg.add_geometry(tri, node_name="bg")
    export_scene(bg, str(video / "bg.glb"))
    write_gzip_sibling(str(video / "bg.glb"))

    textured = TriangleMesh(
        vertices=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
        faces=np.array([[0, 1, 2]], np.int64),
        uv=np.array([[0, 0], [1, 0], [0, 1]], np.float32),
        texture=np.full((4, 4, 3), 128, np.uint8))
    fg = Scene()
    fg.add_geometry(textured, node_name="000000")
    export_scene(fg, str(video / "fg.glb"))

    (video / "metadata.json").write_text(json.dumps(
        {"fps": 30.0, "fov_y": 61, "num_frames": 1, "use_vertex_colour_for_bg": True}))
    return tmp_path / "exports"


@pytest.fixture()
def servers(export_dir):
    """The port's and hive_tpu's servers on ephemeral ports."""
    started = [package.make_server(str(export_dir), port=0)
               for package in (viewer, jax_viewer)]
    for server in started:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    yield started
    for server in started:
        server.shutdown()
        server.server_close()


def _get(server, path, headers):
    conn = http.client.HTTPConnection("localhost", server.server_address[1])
    conn.request("GET", path, headers=headers)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, {k: v for k, v in resp.getheaders() if k != "Date"}, body


REQUESTS = [
    ("/?video=seq01", {}),
    ("/index.html", {"Accept-Encoding": "gzip"}),
    ("/seq01/bg.glb", {}),
    ("/seq01/fg.glb", {}),
    ("/seq01/metadata.json", {}),
    ("/seq01/missing.glb", {}),
    ("/seq01/bg.glb", {"Accept-Encoding": "gzip, deflate"}),
    ("/seq01/bg.glb", {"Accept-Encoding": "*"}),
    ("/seq01/bg.glb", {"Accept-Encoding": "gzip;q=0"}),
    ("/seq01/bg.glb", {"Accept-Encoding": "deflate, gzip;q=0.5"}),
    ("/seq01/fg.glb", {"Accept-Encoding": "gzip"}),
]


@pytest.mark.parametrize("path, headers", REQUESTS)
def test_served_bytes_and_headers_equal_hive_tpu(servers, export_dir, path, headers):
    got, want = (_get(server, path, headers) for server in servers)
    assert got == want
    status, got_headers, body = got
    bg = (export_dir / "seq01" / "bg.glb").read_bytes()
    if path == "/seq01/missing.glb":
        assert status == 404
    elif path == "/seq01/bg.glb" and viewer._accepts_gzip(headers.get("Accept-Encoding", "")):
        assert got_headers["Content-Encoding"] == "gzip" and gzip.decompress(body) == bg
    elif path == "/seq01/bg.glb":
        assert "Content-Encoding" not in got_headers and body == bg
    elif path.startswith(("/?", "/index")):
        assert body == viewer.VIEWER_HTML.read_bytes()


def test_stale_sibling_is_skipped_as_in_hive_tpu(servers, export_dir):
    os.utime(export_dir / "seq01" / "bg.glb.gz", (1, 1))
    got, want = (_get(server, "/seq01/bg.glb", {"Accept-Encoding": "gzip"})
                 for server in servers)
    assert got == want
    assert "Content-Encoding" not in got[1]
    assert got[2] == (export_dir / "seq01" / "bg.glb").read_bytes()


def test_player_page_is_a_byte_copy():
    assert viewer.VIEWER_HTML.read_bytes() == jax_viewer.VIEWER_HTML.read_bytes()
    assert viewer.VIEWER_HTML.parent.name == "viewer"


@pytest.mark.parametrize("header", ["gzip", "GZIP;q=0.1", "gzip;q=0", "gzip;q=0.0", "*",
                                    "*;q=0", "br, deflate", "", "gzip;q=abc", " identity , gzip "])
def test_accept_encoding_parse_matches_hive_tpu(header):
    assert viewer._accepts_gzip(header) == jax_viewer._accepts_gzip(header)


def test_player_covers_every_feature_of_the_ports_writer(export_dir):
    """Tripwire: each glTF feature the port's ``export_scene`` emits is
    handled in the page's JS."""
    html = viewer.VIEWER_HTML.read_text()
    for video in ("seq01/bg.glb", "seq01/fg.glb"):
        glb = (export_dir / video).read_bytes()
        (length,) = struct.unpack_from("<I", glb, 12)
        gltf = json.loads(glb[20:20 + length])
        for mesh in gltf.get("meshes", []):
            for prim in mesh["primitives"]:
                for attr in prim["attributes"]:
                    if attr != "NORMAL":  # the unlit player ignores normals
                        assert attr in html, f"player ignores {attr}"
                assert gltf["accessors"][prim["indices"]]["componentType"] in (5121, 5123, 5125)
        for image in gltf.get("images", []):
            assert image["mimeType"] == "image/png"
    for key in ("parseInt", "fps", "num_frames", "fov_y"):
        assert key in html


def test_viewer_main_lists_the_videos_as_hive_tpu(export_dir, capsys):
    (export_dir / "no_metadata").mkdir()
    printed = []
    for package in (viewer, jax_viewer):
        with mock.patch.object(package, "make_server") as make_server:
            package.main(["--webxr_path", str(export_dir), "--port", "9123"])
        make_server.assert_called_once_with(str(export_dir), 9123)
        make_server.return_value.serve_forever.assert_called_once_with()
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert "http://localhost:9123?video=seq01" in printed[0] and "no_metadata" not in printed[0]


# ---------------------------------------------------------------------------
# The form interface.
# ---------------------------------------------------------------------------

def _comparable(value):
    """Enum members and callables of the two packages' option groups, by
    name."""
    if isinstance(value, enum.Enum):
        return str(value)
    if isinstance(value, (list, tuple)):
        return [_comparable(v) for v in value]
    if callable(value):
        return getattr(value, "__name__", repr(value))
    return value


# The packages' default COLMAP vocabulary paths differ by design (the
# port's lies under the user's home, ROADMAP Queue 3): the form's default
# and help follow its package's option group.
VOCAB = {"port": ("~/.cache/colmap/vocab.bin", "vocabulary-tree file (~ is the user&#x27;s home)."),
         "ref": (jax_options.COLMAPOptions().vocab_path, "vocabulary-tree file.")}


def test_form_fields_equal_hive_tpu():
    got, want = interface._collect_fields(), jax_interface._collect_fields()
    assert [f["name"] for f in got] == [f["name"] for f in want]
    for g, w in zip(got, want):
        if g["name"] == "vocab_path":
            assert (g["default"], w["default"]) == (VOCAB["port"][0], VOCAB["ref"][0])
            g, w = dict(g, default=None, help=None), dict(w, default=None, help=None)
        assert {k: _comparable(v) for k, v in g.items()} == {
            k: _comparable(v) for k, v in w.items()}


FORMS = [
    {"output_path": "out", "dataset_path": "data"},
    {"output_path": "out", "dataset_path": "data", "num_frames": "12",
     "frame_step": "3", "estimate_depth": "on", "background_only": "", "webxr_add_sky_box": "1",
     "webxr_url": "localhost:9000", "sdf_max_voxels": "1000"},
]


@pytest.mark.parametrize("form", FORMS)
def test_form_builds_the_pipeline_hive_tpu_builds(tmp_path, form):
    form = dict(form, log_file=str(tmp_path / "log.txt"), vocab_path="colmap/vocab.bin")
    got = interface.build_pipeline_from_form(form, device="cpu")
    want = jax_interface.build_pipeline_from_form(form)
    assert got.device.type == "cpu"
    for name in ("options", "storage_options", "decimation_options", "dilation_options",
                 "filtering_options", "colmap_options", "background_mesh_options",
                 "webxr_options"):
        g, w = getattr(got, name), getattr(want, name)
        assert ({f.name: _comparable(getattr(g, f.name)) for f in dataclasses.fields(g)}
                == {f.name: _comparable(getattr(w, f.name)) for f in dataclasses.fields(w)})


def test_invalid_form_raises_as_hive_tpu():
    for package in (interface, jax_interface):
        with pytest.raises(ValueError, match="dataset_path and output_path are required"):
            package.build_pipeline_from_form({"num_frames": "x"})


def test_form_page_and_handler_equal_hive_tpu(monkeypatch):
    reference_page = jax_interface.Interface().render_form()
    for ref, port in zip(VOCAB["ref"], VOCAB["port"]):
        reference_page = reference_page.replace(ref, port)
    pages = [interface.Interface().render_form(), reference_page]
    assert pages[0] == pages[1] and 'name="webxr_run_server"' in pages[0]

    ui = interface.Interface(host="127.0.0.1", port=0, device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), ui._make_handler())
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        monkeypatch.setattr(interface, "build_pipeline_from_form",
                            mock.Mock(side_effect=RuntimeError("no dataset")))
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1])
        conn.request("POST", "/run", body="output_path=out&num_frames=3",
                     headers={"Content-Type": "application/x-www-form-urlencoded"})
        body = conn.getresponse().read().decode()
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
    assert "Pipeline failed" in body and "no dataset" in body
    interface.build_pipeline_from_form.assert_called_once_with(
        {"output_path": "out", "num_frames": "3"}, device="cpu")
    assert ui._status == "idle"


# ---------------------------------------------------------------------------
# --webxr_run_server.
# ---------------------------------------------------------------------------

def _argv(tmp_path, *extra):
    return ["--dataset_path", str(tmp_path / "ds"), "--output_path", str(tmp_path / "ds"),
            "--webxr_path", str(tmp_path / "webxr"), "--log_file", str(tmp_path / "log.txt"),
            "--webxr_run_server", *extra]


def test_webxr_run_server_serves_the_export(tmp_path):
    """A whole tiny run on the CPU: the export is written, then the port's
    viewer (its ``main`` patched) is started on the export folder."""
    from hive_tpu_torch.pipeline import Pipeline
    from tests.helpers import make_synthetic_hive_dataset

    make_synthetic_hive_dataset(tmp_path / "ds", num_frames=3, width=64, height=48)
    pipeline = Pipeline.from_command_line(
        _argv(tmp_path, "--num_frames", "3", "--key_frame_threshold", "1.0", "--overwrite_ok",
              "--sdf_max_voxels", "100000"), device="cpu")
    with mock.patch.object(viewer, "main") as viewer_main:
        pipeline.run()
    viewer_main.assert_called_once_with(["--webxr_path", str(tmp_path / "webxr"),
                                         "--port", "8080"])
    assert (tmp_path / "webxr" / "ds" / "bg.glb").is_file()


@pytest.mark.parametrize("url, port", [("http://localhost:9000/view", "9000"),
                                       ("http://localhost:8080", "8080"),
                                       ("http://example.org", "8080"),
                                       ("http://localhost:99999", "8080"),
                                       # hive_tpu's fault, mirrored: no scheme, no port.
                                       ("localhost:9000", "8080")])
def test_viewer_port_follows_the_url_as_in_hive_tpu(tmp_path, url, port):
    from urllib.parse import urlsplit

    from hive_tpu_torch.pipeline import Pipeline

    pipeline = Pipeline.from_command_line(_argv(tmp_path, "--webxr_url", url), device="cpu")
    with mock.patch.object(viewer, "main") as viewer_main:
        pipeline._run_viewer()
    viewer_main.assert_called_once_with(["--webxr_path", str(tmp_path / "webxr"), "--port", port])
    if url == "localhost:9000":
        # urlsplit reads "localhost" as the scheme, as hive_tpu/pipeline.py:309 does.
        assert urlsplit(url).port is None


def test_external_renderer_runs_npm(tmp_path):
    from hive_tpu_torch import pipeline as pipeline_module

    (tmp_path / "renderer" / "node_modules").mkdir(parents=True)
    pipeline = pipeline_module.Pipeline.from_command_line(
        _argv(tmp_path, "--webxr_source_path", str(tmp_path / "renderer")), device="cpu")
    with mock.patch.object(pipeline_module.subprocess, "run") as run, \
            mock.patch.object(viewer, "main") as viewer_main:
        pipeline._run_viewer()
    run.assert_called_once_with(["npm", "run", "start"], cwd=str(tmp_path / "renderer"))
    viewer_main.assert_not_called()


def test_num_devices_still_refused(tmp_path):
    """``--num_devices`` is no longer refused: with ``--webxr_run_server``
    a run whose volume splits over two CPU shards exports, then starts the
    port's viewer (its ``main`` patched) on the export folder."""
    from hive_tpu_torch import fusion
    from hive_tpu_torch.parallel import runtime
    from hive_tpu_torch.pipeline import Pipeline
    from tests.helpers import make_synthetic_hive_dataset

    make_synthetic_hive_dataset(tmp_path / "ds", num_frames=3, width=64, height=48)
    pipeline = Pipeline.from_command_line(
        _argv(tmp_path, "--num_frames", "3", "--key_frame_threshold", "1.0", "--overwrite_ok",
              "--sdf_max_voxels", "100000", "--num_devices", "2"), device="cpu")
    with mock.patch.object(viewer, "main") as viewer_main, \
            mock.patch.object(fusion, "shard_sparse_state",
                              wraps=fusion.shard_sparse_state) as shard:
        pipeline.run()
    assert shard.call_args.args[1].size == 2
    assert runtime.runtime_mesh() is None
    viewer_main.assert_called_once_with(["--webxr_path", str(tmp_path / "webxr"),
                                         "--port", "8080"])
    assert (tmp_path / "webxr" / "ds" / "bg.glb").is_file()
