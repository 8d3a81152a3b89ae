"""Train the SSD detector on synthetic VOC-style records end to end over
the PyTorch port (the twin of ``train.py``; reference
example/ssd/train.py).

    python example/ssd/train_torch.py [--epochs 5] [--ctx gpu|cpu]

Pipeline: dataset_torch.py writes .rec records -> ImageDetRecordIter
batches (B, max_objs, 5) labels on the context -> Module.fit over the
graph (body + heads + MultiBoxTarget + both losses) -> MultiBoxDetection
decode with shared weights. Exits nonzero if the loss fails to decrease.
The card is the default context (``--ctx cpu`` on request).
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train SSD on synthetic records")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--num-images", type=int, default=128)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--ctx", default="gpu", choices=["cpu", "gpu"])
    p.add_argument("--data-dir", default=None)
    return p.parse_args(argv)


def make_metric(mx):
    class MultiBoxMetric(mx.metric.EvalMetric):
        """Cross-entropy on matched anchors + smooth-L1 loc loss (reference
        example/ssd/train/metric.py)."""

        def __init__(self):
            super().__init__("multibox")

        def reset(self):
            self.cls_sum = self.loc_sum = 0.0
            self.num = 0

        def update(self, labels, preds):
            cls_prob, loc_loss, cls_target = preds[0], preds[1], preds[2]
            p = cls_prob.asnumpy()
            t = cls_target.asnumpy().astype(int)
            valid = t >= 0
            picked = np.take_along_axis(p, np.maximum(t, 0)[:, None, :],
                                        axis=1)[:, 0, :]
            ce = -np.log(np.maximum(picked[valid], 1e-12))
            self.cls_sum += ce.sum()
            self.loc_sum += np.abs(loc_loss.asnumpy()).sum()
            self.num += max(int(valid.sum()), 1)

        def get(self):
            return (["cross_entropy", "smooth_l1"],
                    [self.cls_sum / max(self.num, 1),
                     self.loc_sum / max(self.num, 1)])

    return MultiBoxMetric()


def train(args, ctx, arg_params=None, aux_params=None, verbose=True):
    """Write the records, then ``Module.fit`` the training graph for
    ``args.epochs`` epochs (``train.py``'s loop; ``arg_params`` and
    ``aux_params`` start it from given weights). Returns the epoch losses
    (cross-entropy plus smooth-L1 per valid anchor), the module and the
    iterator."""
    import mxnet_tpu_torch as mx
    from dataset_torch import write_records, NUM_CLASSES
    from symbol_ssd_torch import build_ssd

    data_dir = args.data_dir or tempfile.mkdtemp(prefix="ssd_synth_")
    rec = write_records(os.path.join(data_dir, "train"),
                        num_images=args.num_images, size=args.image_size)
    train_iter = mx.io.ImageDetRecordIter(
        rec, data_shape=(3, args.image_size, args.image_size),
        batch_size=args.batch_size, max_objs=4, shuffle=True,
        scale=1.0 / 255, ctx=ctx)

    net = build_ssd(NUM_CLASSES, mode="train")
    mod = mx.mod.Module(net, context=ctx, data_names=["data"],
                        label_names=["label"])

    losses = []
    metric = make_metric(mx)

    def on_epoch(epoch, *_a):
        names, vals = metric.get()
        losses.append(sum(vals))
        if verbose:
            print(f"epoch {epoch}: " +
                  ", ".join(f"{n}={v:.4f}" for n, v in zip(names, vals)),
                  flush=True)
        metric.reset()

    mod.fit(train_iter, num_epoch=args.epochs, optimizer="sgd",
            optimizer_params={"learning_rate": args.lr, "momentum": 0.9,
                              "wd": 1e-4},
            eval_metric=metric, kvstore=None, arg_params=arg_params,
            aux_params=aux_params, epoch_end_callback=on_epoch)
    return losses, mod, train_iter


def main(argv=None):
    args = parse_args(argv)
    import mxnet_tpu_torch as mx
    from dataset_torch import NUM_CLASSES
    from symbol_ssd_torch import build_ssd

    ctx = dict(cpu=mx.cpu, gpu=mx.gpu)[args.ctx]()
    losses, mod, train_iter = train(args, ctx)

    # short smoke runs (< 4 epochs) only need to move downhill; real runs
    # must shed >= 10%
    factor = 0.995 if args.epochs < 4 else 0.9
    assert len(losses) >= 2 and losses[-1] < losses[0] * factor, \
        f"SSD loss failed to decrease: {losses}"
    print(f"loss decreased {losses[0]:.4f} -> {losses[-1]:.4f}")

    # inference: rebind the detection graph with the trained weights
    det_sym = build_ssd(NUM_CLASSES, mode="det")
    det_mod = mx.mod.Module(det_sym, context=ctx, data_names=["data"],
                            label_names=None)
    det_mod.bind(data_shapes=[("data", (args.batch_size, 3, args.image_size,
                                        args.image_size))],
                 for_training=False)
    arg_params, aux_params = mod.get_params()
    det_mod.set_params(arg_params, aux_params, allow_missing=False)
    train_iter.reset()
    batch = train_iter.next()
    det_mod.forward(batch, is_train=False)
    det = det_mod.get_outputs()[0].asnumpy()
    assert det.ndim == 3 and det.shape[2] == 6, det.shape
    keep = det[det[:, :, 0] >= 0]
    print(f"detections on one batch: {len(keep)} boxes, "
          f"best score {keep[:, 1].max() if len(keep) else 0:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
