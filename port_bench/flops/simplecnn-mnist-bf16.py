"""Model FLOPs of SimpleCNN (frozen yardstick): two SAME 3x3
convolutions at full and half resolution, two dense layers; a
multiply-add is 2 FLOPs. Training counts the forward and the backward
once an example, 3x the forward, with no recomputation."""


def forward_flops_per_example(config) -> float:
    H, W, cin = config["input_shape"]
    c1, c2 = config["conv_channels"]
    hidden = config["hidden_size"]
    k = config["num_classes"]
    conv = H * W * 9 * cin * c1 + (H // 2) * (W // 2) * 9 * c1 * c2
    dense = (H // 4) * (W // 4) * c2 * hidden + hidden * k
    return 2.0 * (conv + dense)


def train_flops_per_example(config) -> float:
    return 3.0 * forward_flops_per_example(config)
