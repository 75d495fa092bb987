"""HTTP viewer tests: the handler contract (page, render route, meta
header, input validation, error surfacing) with a stubbed renderer — no
accelerator or real render needed."""

import json
import threading
import urllib.request
import urllib.error

import numpy as np
import pytest


@pytest.fixture()
def server(monkeypatch):
    from http.server import ThreadingHTTPServer

    import nerf_rs_tpu.api as api
    from nerf_rs_tpu.serve import Handler

    calls = {}

    def fake_render(width, height, seed=0):
        if width == 13:  # trigger the error path
            raise RuntimeError("synthetic render failure")
        calls["last"] = (width, height, seed)
        return np.full(height * width * 4, 128, np.uint8)

    monkeypatch.setattr(api, "render_image_rgba", fake_render)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", calls
    srv.shutdown()


def test_serve_page_and_render(server):
    base, calls = server
    page = urllib.request.urlopen(base + "/").read().decode()
    assert "resp.ok" in page  # error surfacing stays in the viewer JS
    resp = urllib.request.urlopen(base + "/render?width=16&height=8&seed=3")
    meta = json.loads(resp.headers["x-render-meta"])
    body = resp.read()
    assert (meta["width"], meta["height"]) == (16, 8)
    assert len(body) == 16 * 8 * 4
    assert calls["last"] == (16, 8, 3)


def test_serve_rejects_bad_query(server):
    base, _ = server
    for q in ("width=abc", "width=0&height=16", "width=4096&height=16",
              "seed=x"):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/render?{q}")
        assert e.value.code == 400, q


def test_serve_surfaces_render_errors(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/render?width=13&height=16")
    assert e.value.code == 500
    assert "synthetic render failure" in e.value.read().decode()


def test_serve_concurrent_requests_serialize_device_dispatch(assets_dir):
    """ThreadingHTTPServer handles /render requests on concurrent threads;
    api._render_lock must serialize the actual device dispatch (one
    frame in flight at a time). Goes through the
    REAL api.render_image_rgba with only render_image stubbed, so the
    locking under test is the production path."""
    import time
    from concurrent.futures import ThreadPoolExecutor
    from http.server import ThreadingHTTPServer

    import nerf_rs_tpu.api as api
    import nerf_rs_tpu.render as render_mod
    from nerf_rs_tpu.serve import Handler

    api._state.clear()
    api.init_renderer(assets_dir=str(assets_dir))
    active = {"n": 0, "max": 0}
    meter = threading.Lock()
    real_render = render_mod.render_image

    def metered_render(pc, pf, cam, h, w, key, cfg, grid=None):
        with meter:
            active["n"] += 1
            active["max"] = max(active["max"], active["n"])
        time.sleep(0.05)  # widen the overlap window
        with meter:
            active["n"] -= 1
        return np.zeros((h, w, 3), np.float32)

    render_mod.render_image = metered_render
    try:
        srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            with ThreadPoolExecutor(max_workers=4) as ex:
                bodies = list(ex.map(
                    lambda i: urllib.request.urlopen(
                        f"{base}/render?width=8&height=8&seed={i}").read(),
                    range(4),
                ))
        finally:
            srv.shutdown()
    finally:
        render_mod.render_image = real_render
        api._state.clear()
    assert all(len(b) == 8 * 8 * 4 for b in bodies)
    assert active["max"] == 1, f"concurrent device dispatch: {active['max']}"


def test_serve_unknown_path_404(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/nope")
    assert e.value.code == 404


def test_serve_page_names_the_device(server):
    """The viewer page says which device renders (JAX's device_kind), not
    a hard-coded accelerator name."""
    import jax

    base, _ = server
    with urllib.request.urlopen(base + "/") as r:
        page = r.read().decode()
    assert f"rendered on {jax.devices()[0].device_kind}" in page
    assert "__DEVICE__" not in page
