"""Shared fit() driver over the PyTorch port (the twin of ``fit.py``;
reference: example/image-classification/common/fit.py).

The same flags and behaviour as ``fit.py``, two quirks included: an
epoch's size for the learning-rate schedule is read from the train
iterator's ``.idx`` (one batch where it has none, as ``MNISTIter`` and
``SyntheticDataIter``), and ``--dtype`` is accepted and ignored. The
device is the card (``--gpus 0``) unless ``--gpus`` is empty; the whole
run, the iterators' arrays included, is made under that context."""
import argparse
import logging
import time

import mxnet_tpu_torch as mx


def add_fit_args(parser):
    train = parser.add_argument_group("Training")
    train.add_argument("--network", type=str, default="mlp")
    train.add_argument("--num-layers", type=int, default=50)
    train.add_argument("--gpus", type=str, default="0",
                       help="ids of cards, e.g. 0; empty = cpu")
    train.add_argument("--kv-store", type=str, default="device")
    train.add_argument("--num-epochs", type=int, default=10)
    train.add_argument("--lr", type=float, default=0.05)
    train.add_argument("--lr-factor", type=float, default=0.1)
    train.add_argument("--lr-step-epochs", type=str, default="10")
    train.add_argument("--optimizer", type=str, default="sgd")
    train.add_argument("--mom", type=float, default=0.9)
    train.add_argument("--wd", type=float, default=1e-4)
    train.add_argument("--batch-size", type=int, default=64)
    train.add_argument("--disp-batches", type=int, default=20)
    train.add_argument("--model-prefix", type=str, default=None)
    train.add_argument("--load-epoch", type=int, default=None)
    train.add_argument("--top-k", type=int, default=0)
    train.add_argument("--dtype", type=str, default="float32")
    train.add_argument("--device-feed", type=int, default=1,
                       help="stage batches onto the device ahead of compute "
                            "(async double-buffered feed; 0 disables)")
    return train


def _get_lr_scheduler(args, kv, epoch_size):
    if not args.lr_factor or args.lr_factor >= 1:
        return args.lr, None
    begin_epoch = args.load_epoch or 0
    step_epochs = [int(l) for l in args.lr_step_epochs.split(",")]
    lr = args.lr
    for s in step_epochs:
        if begin_epoch >= s:
            lr *= args.lr_factor
    steps = [epoch_size * (x - begin_epoch) for x in step_epochs
             if x - begin_epoch > 0]
    if not steps:
        return lr, None
    return lr, mx.lr_scheduler.MultiFactorScheduler(step=steps,
                                                    factor=args.lr_factor,
                                                    base_lr=lr)


def fit(args, network, data_loader, **kwargs):
    """Train ``network`` on the iterators from ``data_loader(args, kv)``
    (reference fit.py:148)."""
    kv = mx.kvstore.create(args.kv_store) if args.kv_store else None
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-15s %(message)s")
    logging.info("start with arguments %s", args)

    devs = [mx.cpu()] if not args.gpus else \
        [mx.gpu(int(i)) for i in args.gpus.split(",")]
    with devs[0]:
        return _fit(args, network, data_loader, kv, devs, **kwargs)


def _fit(args, network, data_loader, kv, devs, **kwargs):
    train, val = data_loader(args, kv)

    epoch_size = max(len(getattr(train, "idx", [0])) // args.batch_size, 1)
    lr, lr_scheduler = _get_lr_scheduler(args, kv, epoch_size)

    if getattr(args, "device_feed", 0):
        # overlap host->device staging of batch k+1 with step k (the
        # reference's PrefetcherIter design, src/io/iter_prefetcher.h:1)
        from mxnet_tpu_torch.io import DeviceFeedIter
        train = DeviceFeedIter(train, ctx=devs[0])
        if val is not None:
            val = DeviceFeedIter(val, ctx=devs[0])

    model = mx.mod.Module(context=devs, symbol=network)

    optimizer_params = {
        "learning_rate": lr,
        "wd": args.wd,
    }
    if args.optimizer in ("sgd", "nag", "signum", "lbsgd"):
        optimizer_params["momentum"] = args.mom
    if lr_scheduler is not None:
        optimizer_params["lr_scheduler"] = lr_scheduler

    eval_metrics = ["accuracy"]
    if args.top_k > 0:
        eval_metrics.append(mx.metric.create("top_k_accuracy", top_k=args.top_k))

    arg_params = aux_params = None
    if args.model_prefix and args.load_epoch is not None:
        _, arg_params, aux_params = mx.model.load_checkpoint(
            args.model_prefix, args.load_epoch)

    checkpoint = mx.callback.do_checkpoint(args.model_prefix) \
        if args.model_prefix else None
    batch_end_cb = mx.callback.Speedometer(args.batch_size, args.disp_batches)

    model.fit(train,
              begin_epoch=args.load_epoch or 0,
              num_epoch=args.num_epochs,
              eval_data=val,
              eval_metric=eval_metrics,
              kvstore=kv,
              optimizer=args.optimizer,
              optimizer_params=optimizer_params,
              initializer=mx.init.Xavier(rnd_type="gaussian",
                                         factor_type="in", magnitude=2),
              arg_params=arg_params,
              aux_params=aux_params,
              batch_end_callback=batch_end_cb,
              epoch_end_callback=checkpoint,
              allow_missing=True)
    return model
