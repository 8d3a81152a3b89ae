"""Network visualization (``mx.viz``).

Counterpart of ``mxnet_tpu/visualization.py`` (reference
``python/mxnet/visualization.py``): ``print_summary`` prints the layer
table with parameter counts, and ``plot_network`` builds the Symbol DAG as
a graphviz digraph (it needs the ``graphviz`` Python package). Both keep
the JAX package's text and counting rules: parameters are counted for
Convolution, FullyConnected, BatchNorm and Embedding only, and a
FullyConnected layer's input width is its input's dimensions after the
first, multiplied (so ``flatten=False`` over a 3-D input counts the
sequence axis too, and an input whose shape is not known by its node's
``_output`` name counts as 0).
"""
from __future__ import annotations

from .symbol import Symbol

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol: Symbol, shape=None, line_length=120,
                  positions=(.44, .64, .74, 1.)):
    """Print a table of layers, output shapes, param counts and connections."""
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be Symbol")
    show_shape = False
    shape_dict = {}
    if shape is not None:
        show_shape = True
        interals = symbol.get_internals()
        _, out_shapes, _ = interals.infer_shape(**shape)
        if out_shapes is None:
            raise ValueError("Input shape is incomplete")
        shape_dict = dict(zip(interals.list_outputs(), out_shapes))

    positions = [int(line_length * p) for p in positions]
    to_display = ['Layer (type)', 'Output Shape', 'Param #', 'Previous Layer']

    def print_row(fields, posns):
        line = ''
        for i, field in enumerate(fields):
            line += str(field)
            line = line[:posns[i]]
            line += ' ' * (posns[i] - len(line))
        print(line)

    print('_' * line_length)
    print_row(to_display, positions)
    print('=' * line_length)

    total_params = [0]

    def print_layer_summary(node, out_shape):
        op = node.op
        pre_nodes = [src.name for (src, _) in node.inputs
                     if src.op is not None or src.name.endswith('data')
                     or not _is_param(src.name)]
        cur_param = 0
        attrs = node.attrs
        if op == 'Convolution':
            num_group = int(attrs.get('num_group', '1'))
            cur_param = _prod(_parse_tuple(attrs['kernel'])) // num_group
            chan = _input_channel(node, shape_dict)
            if chan:
                cur_param *= chan
            cur_param *= int(attrs['num_filter'])
            if attrs.get('no_bias') not in ('True', 'true', True):
                cur_param += int(attrs['num_filter'])
        elif op == 'FullyConnected':
            num_hidden = int(attrs['num_hidden'])
            chan = _input_channel(node, shape_dict, flatten=True)
            cur_param = num_hidden * (chan or 0)
            if attrs.get('no_bias') not in ('True', 'true', True):
                cur_param += num_hidden
        elif op == 'BatchNorm':
            key = node.name + '_output'
            if show_shape and key in shape_dict:
                num_filter = shape_dict[key][1]
                cur_param = int(num_filter) * 2
        elif op == 'Embedding':
            cur_param = int(attrs['input_dim']) * int(attrs['output_dim'])
        first_connection = pre_nodes[0] if pre_nodes else ''
        fields = ['%s(%s)' % (node.name, op), str(out_shape), cur_param,
                  first_connection]
        print_row(fields, positions)
        for conn in pre_nodes[1:]:
            print_row(['', '', '', conn], positions)
        total_params[0] += cur_param

    nodes = symbol.topo_nodes()
    for i, node in enumerate(nodes):
        if node.is_var:
            continue
        out_shape = None
        if show_shape:
            key = node.name + '_output'
            if key in shape_dict:
                out_shape = shape_dict[key]
        print_layer_summary(node, out_shape)
        if i == len(nodes) - 1:
            print('=' * line_length)
        else:
            print('_' * line_length)
    print('Total params: %s' % total_params[0])
    print('_' * line_length)
    return total_params[0]


def _prod(t):
    r = 1
    for x in t:
        r *= x
    return r


def _parse_tuple(s):
    if isinstance(s, (tuple, list)):
        return tuple(int(x) for x in s)
    return tuple(int(x) for x in str(s).strip('()[] ').split(',') if x.strip())


def _is_param(name):
    return name.endswith(('_weight', '_bias', '_gamma', '_beta',
                          '_moving_mean', '_moving_var'))


def _input_channel(node, shape_dict, flatten=False):
    for (src, idx) in node.inputs:
        nm = src.name
        if _is_param(nm):
            continue
        for key in (nm + '_output', nm):
            if key in shape_dict:
                s = shape_dict[key]
                if len(s) > 1:
                    if not flatten:
                        return s[1]
                    # FC consumes the flattened trailing dims
                    c = 1
                    for d in s[1:]:
                        c *= d
                    return c
    return None


def plot_network(symbol, title="plot", save_format='pdf', shape=None,
                 node_attrs=None, hide_weights=True):
    """Build a graphviz Digraph of the Symbol DAG (requires graphviz)."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("plot_network requires the graphviz python "
                          "package") from None
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be a Symbol")

    shape_dict = {}
    draw_shape = False
    if shape is not None:
        draw_shape = True
        interals = symbol.get_internals()
        _, out_shapes, _ = interals.infer_shape(**shape)
        if out_shapes is None:
            raise ValueError("Input shape is incomplete")
        shape_dict = dict(zip(interals.list_outputs(), out_shapes))

    node_attr = {"shape": "box", "fixedsize": "true", "width": "1.3",
                 "height": "0.8034", "style": "filled"}
    node_attr.update(node_attrs or {})
    dot = Digraph(name=title, format=save_format)

    # color palette per op family (reference visualization.py scheme)
    fill_colors = ["#8dd3c7", "#fb8072", "#ffffb3", "#bebada", "#80b1d3",
                   "#fdb462", "#b3de69", "#fccde5"]

    nodes = symbol.topo_nodes()
    hidden = set()
    for node in nodes:
        name = node.name
        attr = dict(node_attr)
        if node.is_var:
            if hide_weights and _is_param(name):
                hidden.add(id(node))
                continue
            attr["fillcolor"] = fill_colors[0]
            label = name
        else:
            op = node.op
            if op == 'Convolution':
                label = "Convolution\n%s/%s, %s" % (
                    node.attrs.get('kernel'), node.attrs.get('stride', '1'),
                    node.attrs.get('num_filter'))
                attr["fillcolor"] = fill_colors[1]
            elif op == 'FullyConnected':
                label = "FullyConnected\n%s" % node.attrs.get('num_hidden')
                attr["fillcolor"] = fill_colors[1]
            elif op == 'BatchNorm':
                label = "BatchNorm"
                attr["fillcolor"] = fill_colors[3]
            elif op == 'Activation' or op == 'LeakyReLU':
                label = "%s\n%s" % (op, node.attrs.get('act_type', ''))
                attr["fillcolor"] = fill_colors[2]
            elif op == 'Pooling':
                label = "Pooling\n%s, %s/%s" % (
                    node.attrs.get('pool_type'), node.attrs.get('kernel'),
                    node.attrs.get('stride', '1'))
                attr["fillcolor"] = fill_colors[4]
            elif op in ('Concat', 'Flatten', 'Reshape'):
                label = op
                attr["fillcolor"] = fill_colors[5]
            elif op == 'Softmax' or op == 'SoftmaxOutput':
                label = op
                attr["fillcolor"] = fill_colors[6]
            else:
                label = op
                attr["fillcolor"] = fill_colors[7]
        dot.node(name=name, label=label, **attr)

    for node in nodes:
        if node.is_var or id(node) in hidden:
            continue
        for (src, idx) in node.inputs:
            if id(src) in hidden:
                continue
            label = ""
            if draw_shape:
                for key in (src.name + '_output', src.name):
                    if key in shape_dict:
                        label = "x".join([str(x) for x in shape_dict[key][1:]])
                        break
            dot.edge(tail_name=src.name, head_name=node.name, label=label,
                     arrowtail="open", dir="back")
    return dot
