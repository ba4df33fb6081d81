"""paddle.flops. Counterpart: paddle_tpu/hapi/dynamic_flops.py: one
forward in eval mode on zeros of `input_size`, counting by forward post
hooks on the leaf sublayers: a convolution out * (2 * in / groups *
prod(k) - 1), a Linear out * (2 * in - 1), a norm or ReLU one a
output element, `custom_ops[type](layer, inputs, output)` for the
types it names."""
import math

__all__ = ["flops"]


def _conv_flops(layer, ins, out):
    k = math.prod(layer._kernel_size)
    cin = layer._in_channels // layer._groups
    return out.size * (2 * cin * k - 1)


def _linear_flops(layer, ins, out):
    return out.size * (2 * layer.in_features - 1)


def flops(net, input_size, custom_ops=None, print_detail=False):
    from ..tensor.creation import zeros
    total = [0]
    hooks = []
    custom_ops = custom_ops or {}

    def hook(layer, ins, out):
        ty = type(layer).__name__
        if type(layer) in custom_ops:
            total[0] += custom_ops[type(layer)](layer, ins, out)
        elif ty.startswith("Conv"):
            total[0] += _conv_flops(layer, ins, out)
        elif ty == "Linear":
            total[0] += _linear_flops(layer, ins, out)
        elif "Norm" in ty or ty.startswith("ReLU"):
            total[0] += out.size if hasattr(out, "shape") else 0

    for _, layer in net.named_sublayers():
        if not layer._sub_layers:
            hooks.append(layer.register_forward_post_hook(hook))
    x = zeros(list(input_size))
    was_training = net.training
    net.eval()
    try:
        net(x)
    finally:
        if was_training:
            net.train()
        for h in hooks:
            h.remove()
    if print_detail:
        print(f"Total FLOPs: {total[0]:,}")
    return int(total[0])
