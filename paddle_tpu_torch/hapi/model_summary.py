"""paddle.summary. Counterpart: paddle_tpu/hapi/model_summary.py: one
forward in eval mode on zeros of `input_size` (or on `input`), each leaf
sublayer's output shape and parameter count by a forward post hook,
printed as a table; returns {"total_params", "trainable_params"}."""
__all__ = ["summary"]


def summary(net, input_size=None, dtypes=None, input=None):
    from ..tensor.creation import zeros
    rows = []
    hooks = []

    def make_hook(name):
        def hook(layer, ins, out):
            if hasattr(out, "shape"):
                oshape = list(out.shape)
            else:
                oshape = [list(o.shape) for o in out if hasattr(o, "shape")]
            n_params = sum(p.numel() for p in layer._parameters.values()
                           if p is not None)
            rows.append((name, type(layer).__name__, oshape, n_params))
        return hook

    for name, layer in net.named_sublayers(include_self=False):
        if not layer._sub_layers:  # leaves only
            hooks.append(layer.register_forward_post_hook(make_hook(name)))

    if input is not None:
        ins = input if isinstance(input, (list, tuple)) else [input]
    else:
        if input_size is None:
            raise ValueError("summary needs input_size or input")
        sizes = input_size if isinstance(input_size, list) else [input_size]
        ins = [zeros([s if s is not None and s != -1 else 1
                      for s in size]) for size in sizes]
    was_training = net.training
    net.eval()
    try:
        net(*ins)
    finally:
        if was_training:
            net.train()
        for h in hooks:
            h.remove()

    total_params = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.trainable)
    width = 76
    print("-" * width)
    print(f"{'Layer (type)':<38}{'Output Shape':<24}{'Param #':<12}")
    print("=" * width)
    for name, ty, oshape, n in rows:
        print(f"{name + ' (' + ty + ')':<38}{str(oshape):<24}{n:<12}")
    print("=" * width)
    print(f"Total params: {total_params:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total_params - trainable:,}")
    print("-" * width)
    return {"total_params": int(total_params),
            "trainable_params": int(trainable)}
