"""ResNet v1/v2 symbol builder (reference:
example/image-classification/symbols/resnet.py — the train_imagenet
``--network resnet[-v1] --num-layers N`` target of the north star).
The twin over the PyTorch port."""
import mxnet_tpu_torch as mx


def residual_unit(data, num_filter, stride, dim_match, name, bottle_neck=True,
                  version=2):
    if version == 1:
        return _unit_v1(data, num_filter, stride, dim_match, name, bottle_neck)
    return _unit_v2(data, num_filter, stride, dim_match, name, bottle_neck)


def _unit_v2(data, num_filter, stride, dim_match, name, bottle_neck):
    bn1 = mx.sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=0.9,
                           name=name + "_bn1")
    act1 = mx.sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    if bottle_neck:
        conv1 = mx.sym.Convolution(act1, num_filter=num_filter // 4,
                                   kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                   no_bias=True, name=name + "_conv1")
        bn2 = mx.sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=0.9,
                               name=name + "_bn2")
        act2 = mx.sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = mx.sym.Convolution(act2, num_filter=num_filter // 4,
                                   kernel=(3, 3), stride=stride, pad=(1, 1),
                                   no_bias=True, name=name + "_conv2")
        bn3 = mx.sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5, momentum=0.9,
                               name=name + "_bn3")
        act3 = mx.sym.Activation(bn3, act_type="relu", name=name + "_relu3")
        conv3 = mx.sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1),
                                   stride=(1, 1), pad=(0, 0), no_bias=True,
                                   name=name + "_conv3")
        body = conv3
    else:
        conv1 = mx.sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                                   stride=stride, pad=(1, 1), no_bias=True,
                                   name=name + "_conv1")
        bn2 = mx.sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=0.9,
                               name=name + "_bn2")
        act2 = mx.sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = mx.sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3),
                                   stride=(1, 1), pad=(1, 1), no_bias=True,
                                   name=name + "_conv2")
        body = conv2
    if dim_match:
        shortcut = data
    else:
        shortcut = mx.sym.Convolution(act1, num_filter=num_filter, kernel=(1, 1),
                                      stride=stride, no_bias=True,
                                      name=name + "_sc")
    return body + shortcut


def _unit_v1(data, num_filter, stride, dim_match, name, bottle_neck):
    if bottle_neck:
        conv1 = mx.sym.Convolution(data, num_filter=num_filter // 4,
                                   kernel=(1, 1), stride=stride, no_bias=True,
                                   name=name + "_conv1")
        bn1 = mx.sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, name=name + "_bn1")
        act1 = mx.sym.Activation(bn1, act_type="relu")
        conv2 = mx.sym.Convolution(act1, num_filter=num_filter // 4,
                                   kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                                   no_bias=True, name=name + "_conv2")
        bn2 = mx.sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5, name=name + "_bn2")
        act2 = mx.sym.Activation(bn2, act_type="relu")
        conv3 = mx.sym.Convolution(act2, num_filter=num_filter, kernel=(1, 1),
                                   no_bias=True, name=name + "_conv3")
        bn3 = mx.sym.BatchNorm(conv3, fix_gamma=False, eps=2e-5, name=name + "_bn3")
        body = bn3
    else:
        conv1 = mx.sym.Convolution(data, num_filter=num_filter, kernel=(3, 3),
                                   stride=stride, pad=(1, 1), no_bias=True,
                                   name=name + "_conv1")
        bn1 = mx.sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, name=name + "_bn1")
        act1 = mx.sym.Activation(bn1, act_type="relu")
        conv2 = mx.sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                                   stride=(1, 1), pad=(1, 1), no_bias=True,
                                   name=name + "_conv2")
        bn2 = mx.sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5, name=name + "_bn2")
        body = bn2
    if dim_match:
        shortcut = data
    else:
        sc_conv = mx.sym.Convolution(data, num_filter=num_filter, kernel=(1, 1),
                                     stride=stride, no_bias=True,
                                     name=name + "_sc")
        shortcut = mx.sym.BatchNorm(sc_conv, fix_gamma=False, eps=2e-5,
                                    name=name + "_sc_bn")
    return mx.sym.Activation(body + shortcut, act_type="relu")


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, version=2):
    data = mx.sym.Variable("data")
    (nchannel, height, width) = image_shape
    if version == 2:
        data = mx.sym.BatchNorm(data, fix_gamma=True, eps=2e-5, name="bn_data")
    if height <= 32:
        body = mx.sym.Convolution(data, num_filter=filter_list[0], kernel=(3, 3),
                                  stride=(1, 1), pad=(1, 1), no_bias=True,
                                  name="conv0")
    else:
        body = mx.sym.Convolution(data, num_filter=filter_list[0], kernel=(7, 7),
                                  stride=(2, 2), pad=(3, 3), no_bias=True,
                                  name="conv0")
        body = mx.sym.BatchNorm(body, fix_gamma=False, eps=2e-5, name="bn0")
        body = mx.sym.Activation(body, act_type="relu", name="relu0")
        body = mx.sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                              pool_type="max")
    for i in range(num_stages):
        stride = (1, 1) if i == 0 else (2, 2)
        body = residual_unit(body, filter_list[i + 1], stride, False,
                             name=f"stage{i+1}_unit1", bottle_neck=bottle_neck,
                             version=version)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name=f"stage{i+1}_unit{j+2}",
                                 bottle_neck=bottle_neck, version=version)
    if version == 2:
        body = mx.sym.BatchNorm(body, fix_gamma=False, eps=2e-5, name="bn1")
        body = mx.sym.Activation(body, act_type="relu", name="relu1")
    pool = mx.sym.Pooling(body, global_pool=True, kernel=(7, 7),
                          pool_type="avg", name="pool1")
    flat = mx.sym.Flatten(pool)
    fc = mx.sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return mx.sym.SoftmaxOutput(fc, mx.sym.Variable("softmax_label"),
                                name="softmax")


def get_symbol(num_classes=1000, num_layers=50, image_shape="3,224,224",
               version=2, **kwargs):
    image_shape = [int(x) for x in image_shape.split(",")]
    (nchannel, height, width) = image_shape
    if height <= 28:
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit = [(num_layers - 2) // 9]
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        else:
            per_unit = [(num_layers - 2) // 6]
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
        units = per_unit * num_stages
    else:
        num_stages = 4
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            bottle_neck = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            bottle_neck = False
        stages = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3], 200: [3, 24, 36, 3]}
        units = stages[num_layers]
    return resnet(units, num_stages, filter_list, num_classes,
                  tuple(image_shape), bottle_neck, version)
