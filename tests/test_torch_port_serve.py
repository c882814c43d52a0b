"""The serving slice of gm3d_tpu_torch as a whole, against gm3d_tpu (CPU).

The same numpy variables go (a) through the JAX package's
``build_classifier_fn`` / ``build_feature_fn`` and (b) through the port's
export CLI (``--device cpu``, from a ``.pth`` written here) and
``ServingModel.predict``. Small sizes: depth 2, width 48, 2 heads, 16 groups x
8 points, 128 points a cloud.

Tolerance: logits ``atol=1e-4`` in fp32 (a handful of matmuls deep; the
grouping indices are equal, so only summation order differs).
"""

import functools
import io
import json
import threading
import urllib.error
import urllib.request
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_threads import torch_at_one_thread  # noqa: F401
from gm3d_tpu.models import GM3DStudent as JGM3DStudent
from gm3d_tpu.models import PointMAE as JPointMAE
from gm3d_tpu.models import PointTransformer as JPointTransformer
from gm3d_tpu.serve import export as jexport
from gm3d_tpu_torch.ckpt import (
    GM3D_STUDENT_MAP,
    POINT_MAE_MAP,
    POINT_TRANSFORMER_MAP,
    state_dict_from_flax,
)
from gm3d_tpu_torch.cli import export_model
from gm3d_tpu_torch.cli import serve as serve_cli
from gm3d_tpu_torch.config import build_model_from_cfg
from gm3d_tpu_torch.models import GM3DStudent
from gm3d_tpu_torch.serve import (DynamicBatcher, ServingModel, build_feature_fn, export_forward,
                                  load_artifact, save_artifact)
from gm3d_tpu_torch.serve.server import make_server
from gm3d_tpu_torch.utils import profiling

NPOINTS, BATCH, CLS = 128, 4, 7
SMALL = dict(trans_dim=48, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=48)
DEC = dict(decoder_depth=1, decoder_num_heads=2)


def _variables(jmodel, *init_args, seed=0):
    """Seeded numpy variables in the tree ``jmodel.init`` would give."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        noise = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "var":
            return 1.0 + 0.5 * np.abs(noise)
        return (1.0 if name == "scale" else 0.0) + 0.1 * noise

    shapes = jax.eval_shape(lambda key: jmodel.init(key, *init_args), jax.random.key(0))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _clouds(seed, b, n=NPOINTS):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(np.float32)


def _write_cfg(path, model: dict) -> str:
    path.write_text(yaml.safe_dump({"model": model, "npoints": NPOINTS}))
    return str(path)


@functools.lru_cache(maxsize=None)
def _classifier():
    jmodel = JPointTransformer(cls_dim=CLS, **SMALL)
    variables = _variables(jmodel, jnp.zeros((2, NPOINTS, 3)))
    return jmodel, variables


@pytest.fixture(scope="module")
def classifier_artifact(tmp_path_factory):
    """The port's export CLI on the CPU, from a .pth in the reference's names."""
    tmp = tmp_path_factory.mktemp("cls")
    _, variables = _classifier()
    pth = tmp / "cls.pth"
    torch.save(state_dict_from_flax(variables, POINT_TRANSFORMER_MAP), pth)
    cfg = _write_cfg(tmp / "cls.yaml", {"NAME": "PointTransformer", "cls_dim": CLS,
                                         "drop_path_rate": 0.1, **SMALL})
    return export_model.main(["--config", cfg, "--ckpt", str(pth), "--device", "cpu",
                              "--out", str(tmp / "cls.gm3dx"),
                              "--export_batch", str(BATCH)]), cfg, str(pth)


@pytest.fixture(scope="module")
def serving(classifier_artifact):
    return ServingModel(classifier_artifact[0], device="cpu")


def _jax_logits(pts):
    jmodel, variables = _classifier()
    fn = jax.jit(jexport.build_classifier_fn(jmodel, variables, NPOINTS))
    return np.asarray(fn(jnp.asarray(pts)))


def test_classifier_logits_match_jax(serving):
    pts = _clouds(1, BATCH)
    got, want = serving.predict(pts), _jax_logits(pts)
    assert got.shape == (BATCH, CLS) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_manifest_fields(serving):
    m = serving.manifest
    assert m["format_version"] == 2 and m["mode"] == "classifier"
    assert m["model"] == "PointTransformer" and m["npoints"] == NPOINTS
    assert m["input_shape"] == [BATCH, NPOINTS, 3] and m["input_dtype"] == "float32"
    assert m["output_shape"] == [BATCH, CLS] and m["output_dtype"] == "float32"
    assert m["platforms"] == ["cpu"] and m["torch_version"] == torch.__version__
    assert "jax_version" not in m and m["compute_dtype"] == "float32"
    assert m["model_cfg"]["trans_dim"] == 48 and m["quantization"] == "none"


def test_in_graph_fps_when_input_is_larger(classifier_artifact, tmp_path):
    _, cfg, pth = classifier_artifact
    art = export_model.main(["--config", cfg, "--ckpt", pth, "--device", "cpu",
                             "--out", str(tmp_path / "big.gm3dx"), "--export_batch", "2",
                             "--input_points", "256"])
    model = ServingModel(art, device="cpu")
    assert model.npoints == 256 and model.manifest["npoints"] == NPOINTS
    pts = _clouds(2, 2, 256)
    want = _jax_logits(pts)
    np.testing.assert_allclose(model.predict(pts), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("family", ["pointmae", "gm3d"])
def test_feature_mode_matches_jax(family, tmp_path):
    pts = _clouds(3, 3)
    mask = jnp.zeros((2, 16), bool).at[:, :9].set(True)
    if family == "pointmae":
        jmodel = JPointMAE(**SMALL, **DEC)
        variables = _variables(jmodel, jnp.zeros((2, NPOINTS, 3)), mask, 9, seed=4)
        pth = tmp_path / "mae.pth"
        torch.save({"base_model": state_dict_from_flax(variables, POINT_MAE_MAP)}, pth)
        cfg = _write_cfg(tmp_path / "mae.yaml", {
            "NAME": "Point_MAE", "group_size": 8, "num_group": 16,
            "transformer_config": dict(trans_dim=48, encoder_dims=48, depth=2, num_heads=2,
                                       drop_path_rate=0.1, **DEC)})
        art = export_model.main(["--config", cfg, "--ckpt", str(pth), "--device", "cpu",
                                 "--mode", "features", "--model_family", "pointmae",
                                 "--out", str(tmp_path / "f.gm3dx"), "--export_batch", "2"])
    else:
        # the CLI exports the student at the reference's hard-coded full
        # width; the small one goes through save_artifact directly
        jmodel = JGM3DStudent(**SMALL, **DEC)
        variables = _variables(jmodel, jnp.zeros((2, NPOINTS, 3)), mask, 9, seed=5)
        model_cfg = dict(SMALL, **DEC, NAME="GM3D_Student", mode="feature")
        model = build_model_from_cfg(model_cfg)
        assert isinstance(model, GM3DStudent)
        model.load_state_dict(state_dict_from_flax(variables, GM3D_STUDENT_MAP), strict=True)
        art = save_artifact(
            str(tmp_path / "f.gm3dx"),
            export_forward(build_feature_fn(model, NPOINTS), torch.zeros(2, NPOINTS, 3)),
            {"mode": "features", "model": "GM3DStudent", "model_cfg": model_cfg,
             "npoints": NPOINTS, "ckpt_step": -1,
             "compute_dtype": "float32", "quantization": "none"})
    serving = ServingModel(art, device="cpu")
    assert serving.manifest["mode"] == "features"
    got = serving.predict(pts)
    want = np.asarray(jax.jit(jexport.build_feature_fn(jmodel, variables, NPOINTS))(
        jnp.asarray(pts)))
    assert got.shape == (3, 48)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_pad_and_chunk(serving):
    pts = _clouds(6, BATCH + 3)
    out = serving.predict(pts)
    assert out.shape == (BATCH + 3, CLS)
    np.testing.assert_allclose(out[:BATCH], serving.predict(pts[:BATCH]), atol=1e-6)
    np.testing.assert_allclose(out[BATCH:], serving.predict(pts[BATCH:]), atol=1e-6)
    single = serving.predict(pts[0])
    assert single.shape == (CLS,)
    np.testing.assert_allclose(single, out[0], atol=1e-6)
    np.testing.assert_allclose(serving.predict(pts[:1])[0], out[0], atol=1e-6)


@pytest.mark.parametrize("bad", [
    np.zeros((2, NPOINTS - 1, 3), np.float32),
    np.zeros((2, NPOINTS, 2), np.float32),
    np.zeros((0, NPOINTS, 3), np.float32),
    np.zeros((NPOINTS,), np.float32),
], ids=["wrong_n", "wrong_dim", "empty", "rank1"])
def test_shape_contract_errors(serving, bad):
    with pytest.raises(ValueError):
        serving.predict(bad)
    fn, _ = load_artifact(serving.path, device="cpu")
    with pytest.raises(ValueError):
        fn(bad)


def test_export_guards(classifier_artifact, tmp_path):
    art, cfg, _ = classifier_artifact
    with pytest.raises(FileNotFoundError):
        export_model.main(["--config", cfg, "--ckpt", str(tmp_path / "missing.pth"),
                           "--device", "cpu", "--out", str(tmp_path / "x.gm3dx")])
    # fan-out: two replicas answer what one does, chunk for chunk
    pts = np.random.default_rng(5).standard_normal((2 * BATCH + 1, NPOINTS, 3)).astype(np.float32)
    fanned = ServingModel(art, devices=["cpu", "cpu"])
    assert fanned.info["serving_devices"] == 2
    np.testing.assert_array_equal(fanned.predict(pts), ServingModel(art, device="cpu").predict(pts))
    assert ServingModel(art, devices=["cpu"]).batch == BATCH
    with pytest.raises(ValueError, match="num_devices"):
        make_server(art, num_devices=0, device="cpu")
    # a manifest of a mode this package does not serve is refused when the
    # artifact is loaded (segmentation is served since its slice came in)
    other = tmp_path / "other.gm3dx"
    with zipfile.ZipFile(art) as src, zipfile.ZipFile(other, "w") as dst:
        manifest = json.loads(src.read("manifest.json"))
        manifest["mode"] = "detection"
        dst.writestr("manifest.json", json.dumps(manifest))
        dst.writestr("program.pt2", src.read("program.pt2"))
    with pytest.raises(ValueError, match="'detection' is not served"):
        load_artifact(str(other), device="cpu")


def test_export_without_ckpt_draws_weights_from_seed(classifier_artifact, tmp_path):
    _, cfg, _ = classifier_artifact
    outs = []
    for name, seed in (("a", "3"), ("b", "3"), ("c", "4")):
        art = export_model.main(["--config", cfg, "--device", "cpu", "--seed", seed,
                                 "--out", str(tmp_path / f"{name}.gm3dx"),
                                 "--export_batch", "2"])
        outs.append(ServingModel(art, device="cpu").predict(_clouds(7, 2)))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.abs(outs[0] - outs[2]).max() > 1e-4
    assert np.isfinite(outs[0]).all()


def _request(url, data=None, ctype="application/json"):
    req = urllib.request.Request(url, data=data)
    if data is not None:
        req.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def http(classifier_artifact):
    server = make_server(classifier_artifact[0], port=0, batch_wait_ms=2.0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server, "http://127.0.0.1:%d" % server.server_address[1]
    server.shutdown()
    server.server_close()
    thread.join()


def test_http_health_and_info(http):
    _, base = http
    assert _request(base + "/health") == (200, {"status": "ok"})
    status, info = _request(base + "/info")
    assert status == 200 and info["input_shape"] == [BATCH, NPOINTS, 3]
    assert info["platforms"] == ["cpu"] and info["format_version"] == 2
    assert set(info["dynamic_batching"]) == {"max_wait_ms", "device_calls", "clouds_served",
                                             "queue_wait_s"}
    assert _request(base + "/nope")[0] == 404


def test_http_predict_json_and_npy(http, serving):
    _, base = http
    pts = _clouds(8, BATCH + 1)
    want = serving.predict(pts)
    status, res = _request(base + "/predict", json.dumps({"points": pts[0].tolist()}).encode())
    assert status == 200
    np.testing.assert_allclose(np.asarray(res["outputs"]), want[0], atol=1e-5)
    assert res["label"] == int(want[0].argmax())
    buf = io.BytesIO()
    np.save(buf, pts)
    status, res = _request(base + "/predict", buf.getvalue(), "application/octet-stream")
    assert status == 200
    np.testing.assert_allclose(np.asarray(res["outputs"]), want, atol=1e-5)
    assert res["label"] == want.argmax(-1).tolist()


@pytest.mark.parametrize("body,ctype", [
    (b"not json", "application/json"),
    (b'{"clouds": []}', "application/json"),
    (b'{"points": [[1, 2]]}', "application/json"),
    (b'{"points": [[[1, 2, 3]], [[1, 2, 3], [4, 5, 6]]]}', "application/json"),
    (b"not an npy file", "application/octet-stream"),
], ids=["garbage", "no_points", "wrong_shape", "ragged", "bad_npy"])
def test_http_bad_body_is_400(http, body, ctype):
    _, base = http
    status, res = _request(base + "/predict", body, ctype)
    assert status == 400 and "error" in res


def test_http_device_failure_is_500(classifier_artifact):
    server = make_server(classifier_artifact[0], port=0, dynamic_batching=False, device="cpu")

    def boom(*args):
        raise RuntimeError("device lost")

    for fn in server.serving_model._fns:  # the loaded program of each serving device
        fn.device_call = boom
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        status, res = _request(base + "/predict",
                               json.dumps({"points": _clouds(9, 1).tolist()}).encode())
        assert status == 500 and "device lost" in res["error"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


def test_http_spans_tie_each_batcher_call_to_its_requests(classifier_artifact):
    """Under a profiler, two concurrent requests: each request's spans, and
    each batcher call listing the requests' waits it served (on another
    thread); the queue's wait grows on /info."""
    server = make_server(classifier_artifact[0], port=0, batch_wait_ms=300.0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    results = [None, None]

    def post(i):
        body = json.dumps({"points": _clouds(20 + i, 1 + i).tolist()}).encode()
        results[i] = _request(base + "/predict", body)

    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        before = _request(base + "/info")[1]["dynamic_batching"]
        profiling.clear()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            posts = [threading.Thread(target=post, args=(i,)) for i in range(2)]
            for t in posts:
                t.start()
            for t in posts:
                t.join(timeout=120)
        after = _request(base + "/info")[1]["dynamic_batching"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    assert not any(t.is_alive() for t in posts)
    assert [r[0] for r in results] == [200, 200]
    records = profiling.spans()
    profiling.clear()
    requests = {r["id"] for r in records if r["name"] == "serve.request"}
    assert len(requests) == 2
    for rid in requests:
        assert sorted(r["name"] for r in records if r["parent"] == rid) == [
            "serve.encode", "serve.parse", "serve.wait"]
    waits = {r["id"] for r in records if r["name"] == "serve.wait"}
    calls = [r for r in records if r["name"] == "batcher.call"]
    assert calls and all(c["attrs"]["waits"] for c in calls)
    assert set().union(*(c["attrs"]["waits"] for c in calls)) == waits
    assert sum(c["attrs"]["clouds"] for c in calls) == 3
    assert all(c["attrs"]["queue_wait_s"] > 0 and c["thread"] == "gm3d-batcher" for c in calls)
    call_ids = {c["id"] for c in calls}
    for name in ("runner.pad", "runner.copy_in", "runner.launch", "runner.read_back"):
        assert [r["parent"] in call_ids for r in records if r["name"] == name] == \
            [True] * len(calls)
    assert after["clouds_served"] - before["clouds_served"] == 3
    waited = sum(c["attrs"]["queue_wait_s"] for c in calls)
    assert after["queue_wait_s"] - before["queue_wait_s"] == pytest.approx(waited)


def test_batcher_coalesces_concurrent_requests(serving):
    batcher = DynamicBatcher(serving, max_wait_ms=200.0)
    pts = _clouds(10, 12)
    want = serving.predict(pts)
    got = [None] * len(pts)

    def worker(i):
        got[i] = batcher.predict(pts[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(pts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        assert batcher.clouds_served == len(pts)
        assert batcher.device_calls < len(pts)
        np.testing.assert_allclose(np.stack(got), want, atol=1e-5)
        np.testing.assert_allclose(batcher.predict(pts[:5]), want[:5], atol=1e-5)
        with pytest.raises(ValueError):
            batcher.predict(np.zeros((1, NPOINTS + 1, 3), np.float32))
    finally:
        batcher.close()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.predict(pts[0])


def test_serve_cli_flags():
    args = serve_cli.parse_args(["--artifact", "m.gm3dx"])
    assert (args.host, args.port, args.batch_wait_ms) == ("127.0.0.1", 8765, 3.0)
    assert args.dynamic_batching is True and args.num_devices == 1 and args.device == "cuda"
    args = serve_cli.parse_args(["--artifact", "m.gm3dx", "--no-dynamic_batching",
                                 "--device", "cpu", "--port", "0"])
    assert args.dynamic_batching is False and args.device == "cpu"
