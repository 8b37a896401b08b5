"""HTTP serving backend: /v1/mmc (chat) and /v1/mmg (generation).

The port's copy of `emu_tpu/serving/backend.py` (it reads the port's
`tokenization`); the routes and the wire format are the same.

Wire-compatible with the reference's Flask backend
(Emu2/demo/backend/pytorch_model/backend.py:95-229): multipart POST with a
`prompt` form field holding a JSON list of ["TEXT", str] | ["IMAGE", key]
pairs (image bytes under the named file field), sampling hyperparameters
as form fields, JSON response {"code": 0|-1, "data": text | base64-WEBP}.

Implemented on the stdlib ThreadingHTTPServer (flask is not in this image);
replicas are checked out of a `Helper` pool per request, and per-request
log ids + latency are logged like the reference. Beside the reference's
routes: GET /healthz, and GET /v1/stats, the recorder's counters and the
medians of its recent requests' queue wait, time to first token and gap
between tokens (`profiling.Recorder.summary`).
"""

from __future__ import annotations

import base64
import io
import json
import logging
import time
import traceback
from email.parser import BytesParser
from email.policy import HTTP
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

logger = logging.getLogger("emu_tpu_torch.serving")


def parse_multipart(headers: Dict[str, str], body: bytes
                    ) -> Tuple[Dict[str, str], Dict[str, bytes]]:
    """→ (form fields, file fields)."""
    ctype = headers.get("Content-Type", headers.get("content-type", ""))
    raw = (b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body)
    msg = BytesParser(policy=HTTP).parsebytes(raw)
    form, files = {}, {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        filename = part.get_filename()
        payload = part.get_payload(decode=True)
        if filename:
            files[name] = payload
        else:
            form[name] = payload.decode()
    return form, files


def _decode_prompt(form: Dict[str, str], files: Dict[str, bytes]):
    from PIL import Image
    from emu_tpu_torch import tokenization as T
    prompt = json.loads(form.get("prompt", "[]"))
    inputs = []
    for t, p in prompt:
        if t == "TEXT":
            inputs.append(p)
        elif t == "VIDEO":
            # p: list of frame file keys (client-sampled frames) — the
            # chat pipeline's video span vocabulary (pipelines/chat.py
            # _prepare_inputs; ref Emu2/emu/chat.py video markers)
            inputs.append(T.VIDEO)
            for key in p:
                inputs.append(Image.open(io.BytesIO(files[key]))
                              .convert("RGB"))
            inputs.append(T.FAKE_VIDEO_END)
        else:
            inputs.append(Image.open(io.BytesIO(files[p])).convert("RGB"))
    return inputs


class EmuHTTPServer:
    """Routes + replica pools; serve() blocks."""

    def __init__(self, chat_helper=None, generation_helper=None):
        self.chat_helper = chat_helper
        self.generation_helper = generation_helper

    # -- route handlers ------------------------------------------------------

    def handle_mmc(self, form: Dict[str, str], files: Dict[str, bytes]
                   ) -> dict:
        log_id = form.get("log_id", "")
        try:
            kwargs = dict(
                do_sample=form.get("do_sample", "False").lower() == "true",
                max_new_tokens=int(form.get("max_new_tokens", 10)),
                temperature=float(form.get("temperature", 0.7)),
                top_k=int(form.get("top_k", 3)),
                top_p=float(form.get("top_p", 0.9)),
                length_penalty=float(form.get("length_penalty", 1)),
                num_beams=int(form.get("num_beams", 5)),
                repetition_penalty=float(form.get("repetition_penalty", 1.0)),
            )
        except ValueError as ex:        # malformed numeric form field →
            return {"code": -1, "data": f"bad form field: {ex}"}
        if "speculative" in form:       # continuous-backend extension
            kwargs["speculative"] = form["speculative"].lower() == "true"
        logger.info("%s: chat request %s", log_id, kwargs)
        pipeline = self.chat_helper.get()
        res = {"code": 0}
        t0 = time.time()
        try:
            inputs = _decode_prompt(form, files)
            res["data"] = pipeline(inputs, **kwargs)
        except Exception as ex:  # noqa: BLE001
            logger.error("%s: chat failed: %s\n%s", log_id, ex,
                         traceback.format_exc())
            res = {"code": -1, "data": str(ex)}
        finally:
            self.chat_helper.put(pipeline)
        logger.info("%s: chat complete code %s, time: %.3fms", log_id,
                    res["code"], (time.time() - t0) * 1000)
        return res

    def handle_mmg(self, form: Dict[str, str], files: Dict[str, bytes]
                   ) -> dict:
        log_id = form.get("log_id", "")
        try:
            cfg = float(form.get("classifier_free_guidance", 3.0))
            steps = int(form.get("steps", 50))
            extra = {}
            # optional resolution/caching fields (extension over the
            # reference API, which hardcodes the pipeline defaults)
            if "height" in form:
                extra["height"] = int(form["height"])
            if "width" in form:
                extra["width"] = int(form["width"])
            if "cache_interval" in form:  # UNet block caching (approximate)
                extra["cache_interval"] = max(1, int(form["cache_interval"]))
        except ValueError as ex:          # malformed numeric form field →
            return {"code": -1, "data": f"bad form field: {ex}"}
        logger.info("%s: generation request cfg=%s steps=%s %s", log_id, cfg,
                    steps, extra)
        pipeline = self.generation_helper.get()
        res = {"code": 0}
        t0 = time.time()
        try:
            inputs = _decode_prompt(form, files)
            out = pipeline(inputs, guidance_scale=cfg,
                           num_inference_steps=steps, **extra)
            image = out.image if hasattr(out, "image") else out[0]
            buf = io.BytesIO()
            image.save(buf, format="WEBP")
            res["data"] = base64.b64encode(buf.getvalue()).decode("ascii")
        except Exception as ex:  # noqa: BLE001
            logger.error("%s: generation failed: %s\n%s", log_id, ex,
                         traceback.format_exc())
            res = {"code": -1, "data": str(ex)}
        finally:
            self.generation_helper.put(pipeline)
        logger.info("%s: generation complete code %s, time: %.3fms", log_id,
                    res["code"], (time.time() - t0) * 1000)
        return res

    def handle(self, path: str, headers, body: bytes) -> Tuple[int, bytes]:
        try:
            form, files = parse_multipart(headers, body)
        except Exception as ex:  # noqa: BLE001
            return 400, json.dumps({"code": -1,
                                    "data": f"bad request: {ex}"}).encode()
        if path == "/v1/mmc" and self.chat_helper is not None:
            return 200, json.dumps(self.handle_mmc(form, files)).encode()
        if path == "/v1/mmg" and self.generation_helper is not None:
            return 200, json.dumps(self.handle_mmg(form, files)).encode()
        return 404, json.dumps({"code": -1, "data": "unknown route"}).encode()


def make_server(server: EmuHTTPServer, host: str = "0.0.0.0",
                port: int = 9002) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            status, payload = server.handle(self.path, self.headers, body)
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):  # noqa: N802
            if self.path == "/":
                from emu_tpu_torch.serving.frontend import FRONTEND_HTML
                body = FRONTEND_HTML.encode()
                ctype = "text/html; charset=utf-8"
            elif self.path == "/healthz":
                body = b'{"status": "ok"}'
                ctype = "application/json"
            elif self.path == "/v1/stats":
                from emu_tpu_torch.utils.profiling import RECORDER
                body = json.dumps(RECORDER.summary()).encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            logger.debug(fmt, *args)

    return ThreadingHTTPServer((host, port), Handler)
