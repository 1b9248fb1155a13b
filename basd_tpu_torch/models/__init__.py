from basd_tpu_torch.models.registry import (
    ModelBundle,
    available_models,
    create_model,
    derive_student_arch,
    estimate_intrinsic_dim,
    init_model,
    load_teacher,
    probe,
    teacher_extract,
)
from basd_tpu_torch.models.tokens import PackedTokens, pack_dense
from basd_tpu_torch.models.vit import ViTConfig, VisionTransformer

__all__ = [
    "ModelBundle",
    "PackedTokens",
    "ViTConfig",
    "VisionTransformer",
    "available_models",
    "create_model",
    "derive_student_arch",
    "estimate_intrinsic_dim",
    "init_model",
    "load_teacher",
    "pack_dense",
    "probe",
    "teacher_extract",
]
