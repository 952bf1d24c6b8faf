"""The port's web page against the JAX package's, and its routes live.

tests/test_webui_js.py validates the page's script (a JS tokenizer, DOM
ids, page functions, declared identifiers); the port serves the same
page, so it is enough that its script is the JAX page's character for
character (the whole page is), and that every URL path the script
fetches, streams or plays is served by a live port ``WebUIServer`` on the
CPU.
"""

import json
import re
import threading
import time
import urllib.request

import pytest
import torch

from sdrpp_tpu.misc import webui as jwebui
from sdrpp_tpu_torch.io.sources import TestSource
from sdrpp_tpu_torch.misc import webui as twebui

torch.set_num_threads(1)


def _script(page):
    return page.split("<script>", 1)[1].rsplit("</script>", 1)[0]


JS = _script(twebui.HTML_PAGE)
PATHS = sorted(set(re.findall(r"fetch\('(/[^'?]*)", JS))
               | set(re.findall(r"EventSource\('(/[^'?]*)", JS))
               | set(re.findall(r"Audio\('(/[^'?]*)", JS)))


def test_page_script_is_the_jax_page_script():
    assert JS == _script(jwebui.HTML_PAGE)
    assert twebui.HTML_PAGE == jwebui.HTML_PAGE
    assert {"/api/state", "/api/fft", "/api/waterfall", "/api/control",
            "/api/bookmarks", "/audio.wav"} <= set(PATHS)


@pytest.fixture(scope="module")
def live():
    src = TestSource(1000000.0, tones=[(100000.0, -20.0)], noise_dbfs=-90.0)
    eng = twebui.ReceiverEngine(src, mode="nfm", offset=100000.0,
                                fft_size=4096, base_block=65536,
                                realtime=False, device="cpu")
    eng.attach_bookmarks()
    srv = twebui.WebUIServer(eng, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    eng.start()
    deadline = time.monotonic() + 120
    while eng.blocks < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert eng.blocks >= 2, eng.error
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    eng.stop()
    srv.shutdown()
    srv.server_close()


@pytest.mark.parametrize("path", PATHS)
def test_every_js_endpoint_is_served(live, path):
    """Each URL path the browser script touches answers 200 on the live
    port server (fails if a JS fetch target and the routes drift)."""
    if path == "/api/control":
        req = urllib.request.Request(
            live + path, data=json.dumps({"action": "auto_range"}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
        return
    url = live + path + ("?since=0" if path == "/api/waterfall" else "")
    with urllib.request.urlopen(url, timeout=30) as r:
        assert r.status == 200
        if path == "/audio.wav":
            assert r.read(4) == b"RIFF"
        elif path in ("/api/state", "/api/bookmarks"):
            assert isinstance(json.loads(r.read()), dict)
