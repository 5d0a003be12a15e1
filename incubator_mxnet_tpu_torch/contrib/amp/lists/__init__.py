from . import symbol_bf16  # noqa: F401
from . import symbol_bf16 as symbol_fp16  # noqa: F401  (the reference's name)
