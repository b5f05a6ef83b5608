"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

#: HBM3 bandwidth, bytes a second
HBM_BYTES_PER_S = 3.35e12
#: TF32 tensor-core rate, operations a second
TF32_FLOP_PER_S = 495e12
#: float32-accurate products on the tensor cores: three TF32 products
#: each (3xTF32, the port's B1), so a tensor-core path of float32
#: accuracy cannot read over 100%
F32_ACCURATE_FLOP_PER_S = TF32_FLOP_PER_S / 3
