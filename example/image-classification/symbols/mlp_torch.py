"""MLP symbol (reference: example/image-classification/symbols/mlp.py).
The twin over the PyTorch port."""
import mxnet_tpu_torch as mx


def get_symbol(num_classes=10, **kwargs):
    data = mx.sym.Variable("data")
    data = mx.sym.Flatten(data)
    fc1 = mx.sym.FullyConnected(data, num_hidden=128, name="fc1")
    act1 = mx.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = mx.sym.FullyConnected(act1, num_hidden=64, name="fc2")
    act2 = mx.sym.Activation(fc2, act_type="relu", name="relu2")
    fc3 = mx.sym.FullyConnected(act2, num_hidden=num_classes, name="fc3")
    return mx.sym.SoftmaxOutput(fc3, mx.sym.Variable("softmax_label"),
                                name="softmax")
