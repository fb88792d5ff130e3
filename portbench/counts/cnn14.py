"""Floating-point operations of the AFx-Rep Cnn14, from its configuration:
each 3x3 convolution 2 Cin Cout 9 H W at its input's size (no bias), the
linear head 2 C D; the front end, BatchNorm, ReLU and pooling are left out.
One item is one of mid or side of one clip."""


def forward_flops(enc: dict, samples: int) -> float:
    H = samples // enc["hop_size"] + 1
    W = enc["mel_bins"]
    b = enc["base_channels"]
    flops, cin = 0.0, 1
    for i, c in enumerate((b, 2 * b, 4 * b, 8 * b, 16 * b, 32 * b)):
        flops += 2.0 * 9 * H * W * (cin * c + c * c)
        cin = c
        if i < 5:
            H, W = H // 2, W // 2
    return flops + 2.0 * cin * enc["embed_dim"]
