"""AMP's op lists (the port's copy of ``incubator_mxnet_tpu/contrib/amp/
lists/symbol_bf16.py``): FP16_FUNCS (the reference's name, for either
low-precision target) holds the matmul and convolution ops, which run on
the tensor cores in bfloat16 or float16; FP32_FUNCS the numerically
sensitive ones; WIDEST_TYPE_CASTS the multi-input elementwise ops, which
compute in the widest of their input types by PyTorch's promotion, as by
JAX's in the reference.
"""

# ops that run in low precision (matmul and convolution)
FP16_FUNCS = [
    "Convolution",
    "Deconvolution",
    "FullyConnected",
    "RNN",
    "dot",
    "batch_dot",
    "_contrib_interleaved_matmul_selfatt_qk",
    "_contrib_interleaved_matmul_selfatt_valatt",
    "_contrib_interleaved_matmul_encdec_qk",
    "_contrib_interleaved_matmul_encdec_valatt",
]

# ops forced to float32 (reductions / exponentials / losses / norms)
FP32_FUNCS = [
    "softmax",
    "log_softmax",
    "SoftmaxOutput",
    "softmax_cross_entropy",
    "SoftmaxActivation",
    "LinearRegressionOutput",
    "LogisticRegressionOutput",
    "MAERegressionOutput",
    "BatchNorm",
    "LayerNorm",
    "InstanceNorm",
    "GroupNorm",
    "L2Normalization",
    "LRN",
    "norm",
    "exp",
    "log",
    "log2",
    "log10",
    "log1p",
    "expm1",
    "square",
    "sqrt",
    "rsqrt",
    "cbrt",
    "rcbrt",
    "pow",
    "broadcast_power",
    "mean",
    "sum",
    "nansum",
    "prod",
    "nanprod",
    "CTCLoss",
    "smooth_l1",
    "MakeLoss",
]

# multi-input elementwise ops cast to the widest input type: type
# promotion already computes bf16 + f32 in f32, so no cast is inserted;
# the list names the ops that rely on it
WIDEST_TYPE_CASTS = [
    "elemwise_add",
    "elemwise_sub",
    "elemwise_mul",
    "elemwise_div",
    "broadcast_add",
    "broadcast_sub",
    "broadcast_mul",
    "broadcast_div",
    "broadcast_maximum",
    "broadcast_minimum",
    "Concat",
    "concat",
    "where",
]

# everything else runs in whatever dtype its inputs carry
CONDITIONAL_FP32_FUNCS = [
    ("Activation", "act_type", ["softrelu"]),
    ("LeakyReLU", "act_type", ["elu", "selu"]),
]

LOSS_OUTPUT_FUNCS = ["SoftmaxOutput", "LinearRegressionOutput",
                     "LogisticRegressionOutput", "MAERegressionOutput"]
