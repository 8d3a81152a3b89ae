"""LeNet symbol (reference: example/image-classification/symbols/lenet.py).
North-star config #1: train_mnist.py --network lenet.
The twin over the PyTorch port."""
import mxnet_tpu_torch as mx


def get_symbol(num_classes=10, add_stn=False, **kwargs):
    data = mx.sym.Variable("data")
    conv1 = mx.sym.Convolution(data, kernel=(5, 5), num_filter=20, name="conv1")
    tanh1 = mx.sym.Activation(conv1, act_type="tanh")
    pool1 = mx.sym.Pooling(tanh1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    conv2 = mx.sym.Convolution(pool1, kernel=(5, 5), num_filter=50, name="conv2")
    tanh2 = mx.sym.Activation(conv2, act_type="tanh")
    pool2 = mx.sym.Pooling(tanh2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    flatten = mx.sym.Flatten(pool2)
    fc1 = mx.sym.FullyConnected(flatten, num_hidden=500, name="fc1")
    tanh3 = mx.sym.Activation(fc1, act_type="tanh")
    fc2 = mx.sym.FullyConnected(tanh3, num_hidden=num_classes, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, mx.sym.Variable("softmax_label"),
                                name="softmax")
