"""Web UI for launching the pipeline (every CLI option exposed as a form).

Counterpart of ``hive_tpu/interface.py``, serving on 0.0.0.0:8081. Uses
Gradio when installed; otherwise a dependency-free stdlib HTTP server renders
the same form and runs the pipeline in-process: one field per CLI flag of
``hive_tpu``'s option groups, with the same names and defaults, either way.
The pipeline runs on the card unless the interface is built with
``device="cpu"``.

Usage::

    python -m hive_tpu_torch.interface
"""

from __future__ import annotations

import argparse
import html
import logging
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List
from urllib.parse import parse_qs

from hive_tpu_torch.options import (BackgroundMeshOptions, COLMAPOptions,
                                    MaskDilationOptions, MeshDecimationOptions,
                                    MeshFilteringOptions, PipelineOptions, StorageOptions,
                                    WebXROptions)

ALL_OPTION_GROUPS = [PipelineOptions, StorageOptions, MaskDilationOptions,
                     MeshFilteringOptions, MeshDecimationOptions, COLMAPOptions,
                     BackgroundMeshOptions, WebXROptions]


def _collect_fields() -> List[dict]:
    """Introspect the CLI option groups into form-field descriptors."""
    parser = argparse.ArgumentParser()

    for group in ALL_OPTION_GROUPS:
        group.add_args(parser)

    fields = []

    for action in parser._actions:
        if action.dest in ("help",):
            continue

        field = {
            "name": action.dest,
            "flag": action.option_strings[0] if action.option_strings else action.dest,
            "help": action.help or "",
            "default": action.default,
            "required": action.required,
            "choices": list(action.choices) if action.choices else None,
            "is_flag": isinstance(action, argparse._StoreTrueAction),
            "type": action.type,
        }
        fields.append(field)

    return fields


def build_pipeline_from_form(form: Dict[str, str], device=None):
    """Build a Pipeline from submitted form values (same path as the CLI).

    :param device: where the pipeline runs; default ``cuda:0``.
    """
    from hive_tpu_torch.pipeline import Pipeline

    argv = []

    for field in _collect_fields():
        name = field["name"]
        value = form.get(name, "")

        if field["is_flag"]:
            if value in ("on", "true", "1"):
                argv.append(field["flag"])
        elif value not in ("", None):
            argv += [field["flag"], value]

    parser = argparse.ArgumentParser()
    for group in ALL_OPTION_GROUPS:
        group.add_args(parser)

    try:
        args = parser.parse_args(argv)
    except SystemExit:
        # argparse exits on errors (missing --dataset_path, bad int, ...);
        # SystemExit is a BaseException that would escape the web handler's
        # `except Exception` and kill the request with no response.
        raise ValueError("Invalid pipeline options "
                         f"({' '.join(argv) if argv else 'empty form'}); "
                         "dataset_path and output_path are required.")

    return Pipeline(
        options=PipelineOptions.from_args(args),
        storage_options=StorageOptions.from_args(args),
        decimation_options=MeshDecimationOptions.from_args(args),
        dilation_options=MaskDilationOptions.from_args(args),
        filtering_options=MeshFilteringOptions.from_args(args),
        colmap_options=COLMAPOptions.from_args(args),
        static_mesh_options=BackgroundMeshOptions.from_args(args),
        webxr_options=WebXROptions.from_args(args),
        device=device,
    )


class Interface:
    """The web interface: form in, pipeline run out."""

    def __init__(self, host: str = "0.0.0.0", port: int = 8081, device=None):
        self.host = host
        self.port = port
        self.device = device
        self._status: str = "idle"
        self._lock = threading.Lock()

    # -- shared submission handler -------------------------------------------
    def start_pipeline(self, form: Dict[str, str]) -> str:
        with self._lock:
            if self._status == "running":
                return "A pipeline run is already in progress."
            self._status = "running"

        try:
            pipeline = build_pipeline_from_form(form, device=self.device)
            pipeline.run()
            result = "Pipeline finished successfully."
        except Exception:
            result = f"Pipeline failed:\n{traceback.format_exc()}"
            logging.error(result)
        finally:
            with self._lock:
                self._status = "idle"

        return result

    # -- gradio path ----------------------------------------------------------
    def _launch_gradio(self):  # pragma: no cover - optional dependency
        import gradio as gr

        fields = _collect_fields()
        inputs = []

        for field in fields:
            label = f"{field['name']} — {field['help']}"

            if field["is_flag"]:
                inputs.append(gr.Checkbox(value=bool(field["default"]), label=label))
            elif field["choices"]:
                inputs.append(gr.Dropdown(choices=[str(c) for c in field["choices"]],
                                          value=str(field["default"]), label=label))
            else:
                inputs.append(gr.Textbox(
                    value="" if field["default"] is None else str(field["default"]),
                    label=label))

        def submit(*values):
            form = {}
            for field, value in zip(fields, values):
                form[field["name"]] = ("on" if value else "") if field["is_flag"] \
                    else str(value)
            return self.start_pipeline(form)

        demo = gr.Interface(fn=submit, inputs=inputs, outputs="text", title="HIVE-TPU")
        demo.launch(server_name=self.host, server_port=self.port)

    # -- stdlib path ----------------------------------------------------------
    def render_form(self) -> str:
        rows = []

        for field in _collect_fields():
            help_text = html.escape(field["help"])
            name = field["name"]

            if field["is_flag"]:
                control = (f'<input type="checkbox" name="{name}" '
                           + ("checked" if field["default"] else "") + ">")
            elif field["choices"]:
                options = "".join(
                    f'<option value="{c}" '
                    + ("selected" if str(c) == str(field["default"]) else "")
                    + f">{c}</option>" for c in field["choices"])
                control = f'<select name="{name}">{options}</select>'
            else:
                default = "" if field["default"] is None else html.escape(str(field["default"]))
                control = f'<input type="text" name="{name}" value="{default}">'

            rows.append(f"<tr><td><b>{name}</b></td><td>{control}</td>"
                        f"<td><small>{help_text}</small></td></tr>")

        return ("<html><head><title>HIVE-TPU</title></head><body>"
                "<h1>HIVE-TPU — create a 3D mesh video</h1>"
                f"<p>Status: {self._status}</p>"
                '<form method="POST" action="/run"><table>'
                + "".join(rows)
                + '</table><button type="submit">Start Pipeline</button></form>'
                  "</body></html>")

    def _make_handler(interface):  # noqa: N805 - closure over the interface
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logging.debug("HTTP: " + fmt % args)

            def do_GET(self):
                body = interface.render_form().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                payload = self.rfile.read(length).decode("utf-8")
                form = {key: values[0] for key, values in parse_qs(payload).items()}

                result = interface.start_pipeline(form)

                body = (f"<html><body><h1>HIVE-TPU</h1><pre>{html.escape(result)}</pre>"
                        f'<a href="/">back</a></body></html>').encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return Handler

    def launch(self):
        try:
            import gradio  # noqa: F401

            self._launch_gradio()
            return
        except ImportError:
            logging.info("Gradio not installed; serving the built-in HTML interface.")

        server = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        logging.info(f"HIVE-TPU interface listening on http://{self.host}:{self.port}")
        server.serve_forever()


def main():
    from hive_tpu_torch.utils import setup_logger

    setup_logger()
    Interface().launch()


if __name__ == "__main__":
    main()
