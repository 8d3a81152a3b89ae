"""PyTorch port, the model files' operational modules against the JAX
package's: ``checkpoint.ShardedCheckpointer`` (the commit protocol, the
manifest, the async save, restore onto ``like=``), ``monitor.Monitor``
through ``Module.fit(monitor=)`` and ``mx.viz`` (``print_summary``'s table,
``plot_network``'s DOT source).

One item loops over named cases and names the ones that fail. Every case
feeds the same numpy inputs, made from a seed, to both packages. The two
checkpointers' payloads differ (orbax's against raw files: ROADMAP C), so
the checkpoint case compares what each package reports and restores:
steps, latest step, manifest keys and user metadata, ``verify``, and the
restored values bitwise, bfloat16 included. Tolerances: the monitor's
values within 1e-6 relative; everything else exact.
"""
import contextlib
import importlib.util
import io
import os
import shutil

import numpy as np
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
TOL_MONITOR = 1e-6


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_checkpoint", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------ checkpoint
def _trees(seed):
    """params (float32, bfloat16, int32) and aux as numpy; bf16 as the
    float32 values it rounds to."""
    rs = np.random.RandomState(seed)
    bf16 = torch.from_numpy(rs.randn(4, 6).astype("float32")).bfloat16()
    params = {"fc_weight": rs.randn(8, 5).astype("float32"),
              "fc_bias": rs.randn(8).astype("float32"),
              "emb_weight": bf16,
              "ids": rs.randint(0, 50, (3, 2)).astype("int32")}
    aux = {"moving_mean": rs.randn(8).astype("float32")}
    return params, aux


def _jax_tree(tree):
    import jax.numpy as jnp
    return {k: jnp.asarray(v.float().numpy(), dtype=jnp.bfloat16)
            if isinstance(v, torch.Tensor) else jnp.asarray(v)
            for k, v in tree.items()}


def _torch_tree(tree):
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
            for k, v in tree.items()}


def _as_numpy(tree):
    """Restored arrays as numpy, bfloat16 by its bit pattern."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            out[k] = (v.view(torch.int16).numpy() if v.dtype == torch.bfloat16
                      else v.numpy(), str(v.dtype).replace("torch.", ""))
        else:
            a = np.asarray(v)
            out[k] = (a.view(np.int16) if a.dtype.name == "bfloat16" else a,
                      a.dtype.name)
    return out


def _checkpoint_run(pkg, root, trees, torn_file):
    """One sequence of saves and queries; what each step reports."""
    ck = pkg.checkpoint.ShardedCheckpointer(root)
    conv = _jax_tree if pkg is jmx else _torch_tree
    (p1, a1), (p2, _), (p3, a3) = trees
    rec = {}
    ck.save(1, conv(p1), aux=conv(a1), manifest={"run": "a", "epoch": 1})
    ck.save(2, conv(p2), async_save=True)
    ck.save(2, conv(p3), aux=conv(a3), async_save=True)   # overwrite
    try:
        ck.save(2, conv(p1), overwrite=False)
        rec["overwrite_false"] = "saved"
    except pkg.MXNetError:
        rec["overwrite_false"] = "raised"
    rec["steps"] = ck.steps()
    rec["latest"] = ck.latest_step()
    man = ck.read_manifest(1)
    rec["manifest_keys"] = sorted(man)
    rec["manifest_user"] = man["user"]
    rec["manifest_step"] = man["step"]
    rec["file_keys"] = sorted({k for e in man["files"] for k in e})
    ck.save(3, conv(p1))
    ck.save(4, conv(p2), async_save=True)
    rec["prune_newer"] = ck.prune_newer(2)
    rec["after_prune"] = ck.steps()
    # an uncommitted copy of a committed step: listed only after adopt
    shutil.copytree(os.path.join(root, "step_2"),
                    os.path.join(root, "step_7"))
    for name in ("_MXTPU_COMMITTED", "_MXTPU_MANIFEST.json"):
        os.remove(os.path.join(root, "step_7", name))
    rec["before_adopt"] = ck.steps()
    rec["verify_uncommitted"] = ck.verify(7)
    ck.adopt(7)
    rec["after_adopt"] = ck.steps()
    rec["verify_adopted"] = ck.verify(7)
    rec["adopted_user"] = ck.read_manifest(7)["user"]
    os.makedirs(os.path.join(root, ".pending_step_9.1.deadbeef"))
    ck.gc()
    rec["gc_stale"] = sorted(os.listdir(root))
    like = conv(p1)
    with (jmx.cpu() if pkg is jmx else mx.cpu()):
        rec["restored_1"] = _as_numpy(ck.restore(1, like=like))
        rec["restored_2"] = _as_numpy(ck.restore(2, like=like))
    rec["verify_2"] = ck.verify(2)
    files = ck.read_manifest(2)["files"]
    victim = torn_file(files)
    with open(os.path.join(root, "step_2", victim), "r+b") as f:
        f.truncate(os.path.getsize(f.name) // 2)
    rec["verify_torn"] = ck.verify(2)
    try:
        ck.restore(2, like=like)
        rec["restore_torn"] = "restored"
    except pkg.MXNetError:
        rec["restore_torn"] = "raised"
    ck.gc(keep=1)
    rec["gc_keep_1"] = ck.steps()
    ck.close()
    return rec


def _largest(files):
    return max(files, key=lambda e: (e["size"], e["path"]))["path"]


def _case_checkpoint(tmp):
    trees = [_trees(s) for s in (1, 2, 3)]
    j = _checkpoint_run(jmx, os.path.join(tmp, "jax"), trees, _largest)
    p = _checkpoint_run(mx, os.path.join(tmp, "port"), trees, _largest)
    bad = []
    for key in j:
        if key == "gc_stale":
            same = j[key] == p[key]
        elif key.startswith("restored"):
            same = (sorted(j[key]) == sorted(p[key]) and all(
                j[key][n][1] == p[key][n][1]
                and np.array_equal(j[key][n][0], p[key][n][0])
                for n in j[key]))
        else:
            same = j[key] == p[key]
        if not same:
            bad.append(f"{key}: jax {j[key]!r} port {p[key]!r}")
    assert p["restore_torn"] == "raised" and not p["verify_torn"]
    assert p["steps"] == [1, 2] and p["after_adopt"] == [1, 2, 7]
    assert not bad, bad


def _case_async_snapshot(tmp):
    """An in-place update right after an async save does not reach the
    file; the restore lands on like='s device and dtype; a shape that
    differs raises; a failed write raises at the join."""
    ck = mx.checkpoint.ShardedCheckpointer(os.path.join(tmp, "snap"))
    w = torch.from_numpy(np.random.RandomState(4).randn(64, 32)
                         .astype("float32"))
    want = w.clone()
    ck.save(5, {"w": w}, async_save=True)
    w.mul_(3.0).add_(1.0)
    got = ck.restore(5, like={"w": torch.zeros(64, 32, dtype=torch.float64)})
    assert got["w"].dtype == torch.float64
    assert torch.equal(got["w"], want.double())
    try:
        ck.restore(5, like={"w": torch.zeros(32, 64)})
        raise AssertionError("a shape mismatch restored")
    except mx.MXNetError:
        pass
    # a write that fails raises where the save is joined, and commits nothing
    real = mx.checkpoint._write_raw

    def full_disk(path, t):
        raise OSError(28, "No space left on device")

    mx.checkpoint._write_raw = full_disk
    try:
        ck.save(6, {"w": w}, async_save=True)
        try:
            ck.wait_until_finished()
            raise AssertionError("a failed write did not raise")
        except mx.MXNetError as e:
            assert "No space left" in str(e), e
    finally:
        mx.checkpoint._write_raw = real
    assert ck.steps() == [5]
    ck.close()


# --------------------------------------------------------------- monitor
def _mlp(pkg):
    s = pkg.sym
    x = s.FullyConnected(s.Variable("data"), num_hidden=16, name="fc1")
    x = s.Activation(x, act_type="tanh", name="tanh1")
    x = s.FullyConnected(x, num_hidden=3, name="fc2")
    return s.LinearRegressionOutput(x, s.Variable("lin_label"), name="lin")


def _monitor_run(pkg, values, data, label, interval, sort, stat):
    """``Module.fit(monitor=)`` over two epochs of three batches; each
    ``toc()`` list and the raw statistics it formatted."""
    tocs, raw = [], []

    class Recorder(pkg.monitor.Monitor):
        def toc(self):
            raw.extend((n, k, float(np.asarray(v.asnumpy()).reshape(-1)[0]))
                       for n, k, v in self.queue)
            out = super().toc()
            tocs.append(out)
            return out

    mon = Recorder(interval, stat_func=stat, pattern=".*", sort=sort)
    ctx = pkg.cpu()
    it = pkg.io.NDArrayIter(data, label, batch_size=4, shuffle=False,
                            label_name="lin_label")
    mod = pkg.mod.Module(_mlp(pkg), data_names=("data",),
                         label_names=("lin_label",), context=ctx,
                         passes=False)
    arg = {k: pkg.nd.array(v, ctx=ctx) for k, v in values.items()}
    mod.fit(it, num_epoch=2, optimizer="sgd", eval_metric="mse",
            optimizer_params={"learning_rate": 0.1}, arg_params=arg,
            monitor=mon)
    return tocs, raw


def _case_monitor(tmp):
    rs = np.random.RandomState(7)
    values = {"fc1_weight": rs.randn(16, 5).astype("float32") * 0.3,
              "fc1_bias": rs.randn(16).astype("float32") * 0.1,
              "fc2_weight": rs.randn(3, 16).astype("float32") * 0.3,
              "fc2_bias": rs.randn(3).astype("float32") * 0.1}
    data = rs.randn(12, 5).astype("float32")
    label = rs.randn(12, 3).astype("float32")
    cases = {"default": (1, False, None, None),
             "interval_2_sorted_norm": (2, True,
                                        lambda x: jmx.nd.norm(x),
                                        lambda x: mx.nd.norm(x))}
    bad = []
    for name, (interval, sort, jstat, pstat) in cases.items():
        jt, jr = _monitor_run(jmx, values, data, label, interval, sort, jstat)
        pt, pr = _monitor_run(mx, values, data, label, interval, sort, pstat)
        if [[(n, k) for n, k, _ in t] for t in jt] != \
                [[(n, k) for n, k, _ in t] for t in pt]:
            bad.append(f"{name}: steps and names {jt} against {pt}")
            continue
        if not jr or [r[:2] for r in jr] != [r[:2] for r in pr]:
            bad.append(f"{name}: raw taps {jr} against {pr}")
            continue
        errs = [abs(a[2] - b[2]) / max(abs(a[2]), 1e-30)
                for a, b in zip(jr, pr)]
        if max(errs) > TOL_MONITOR:
            bad.append(f"{name}: values {max(errs):.2e} apart")
        strings = [(float(a[2]), float(b[2])) for ta, tb in zip(jt, pt)
                   for a, b in zip(ta, tb)]
        if any(abs(a - b) > 1.01e-5 for a, b in strings):
            bad.append(f"{name}: printed values {strings}")
    assert not bad, bad


# ------------------------------------------------------------------ viz
def _conv_net(pkg):
    s = pkg.sym
    x = s.Convolution(s.Variable("data"), kernel=(3, 3), num_filter=8,
                      pad=(1, 1), name="conv1")
    x = s.BatchNorm(x, name="bn1")
    x = s.Activation(x, act_type="relu")
    x = s.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
    x = s.Convolution(x, kernel=(3, 3), num_filter=4, num_group=2,
                      no_bias=True, name="conv2")
    x = s.Flatten(x)
    x = s.FullyConnected(x, num_hidden=10, name="fc")
    return s.SoftmaxOutput(x, name="softmax")


def _viz_run(pkg, cs):
    out = {}
    cfg = dict(vocab=50, units=16, layers=2, heads=2, ffn=32)
    shapes = {"conv": {"data": (2, 3, 12, 12), "softmax_label": (2,)},
              "lm": {"data": (2, 8), "pos_table": (8, 16)}}
    with pkg.name.NameManager():
        nets = {"conv": _conv_net(pkg),
                "lm": cs.build_lm_symbol(pkg.sym, cfg["vocab"], cfg["units"],
                                         cfg["layers"], cfg["heads"],
                                         cfg["ffn"], max_len=8)}
    for name, net in nets.items():
        for shaped in (False, True):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                total = pkg.viz.print_summary(
                    net, shape=shapes[name] if shaped else None)
            out[f"summary {name} shape={shaped}"] = (buf.getvalue(), total)
            try:
                for hide in (True, False):
                    dot = pkg.viz.plot_network(
                        net, shape=shapes[name] if shaped else None,
                        hide_weights=hide)
                    out[f"dot {name} shape={shaped} hide={hide}"] = dot.source
            except ImportError as e:
                out[f"dot {name} shape={shaped}"] = f"ImportError {e}"
    return out


def _case_viz(tmp):
    cs = _chip_smoke()
    j, p = _viz_run(jmx, cs), _viz_run(mx, cs)
    assert sorted(j) == sorted(p)
    bad = [k for k in j if j[k] != p[k]]
    assert not bad, [(k, j[k], p[k]) for k in bad]
    assert mx.viz is mx.visualization


CASES = {"checkpoint": _case_checkpoint,
         "async_snapshot": _case_async_snapshot,
         "monitor": _case_monitor,
         "viz": _case_viz}


def test_checkpoint_monitor_and_viz_match_jax(tmp_path):
    failed = []
    for name, case in CASES.items():
        try:
            case(str(tmp_path / name))
        except Exception as e:
            failed.append(f"{name}: {type(e).__name__}: {e}")
    assert not failed, "\n".join(failed)
