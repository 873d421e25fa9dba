"""The port's configurations: the paper's clustering workloads
(``configs.gkmeans_paper``) and the LM architectures of the reference's
template (``configs.base``; importing this package registers every one, as
``repro.configs`` does)."""
import importlib

from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeSpec,
                                      get_config, list_archs, register)
from repro_torch.configs.gkmeans_paper import (GIST1M, GLOVE1M, SIFT1M,
                                               SIFT_SMALL, VLAD10M,
                                               VLAD_SMALL, ClusterConfig)

for _arch in ("qwen2_72b", "llama3_405b", "qwen15_4b", "chatglm3_6b",
              "whisper_base", "internvl2_2b", "mamba2_27b", "grok1_314b",
              "qwen2_moe_a27b", "recurrentgemma_9b"):
    importlib.import_module(f"repro_torch.configs.{_arch}")
del _arch, importlib

__all__ = ["ClusterConfig", "SIFT1M", "VLAD10M", "GLOVE1M", "GIST1M",
           "SIFT_SMALL", "VLAD_SMALL", "ArchConfig", "ShapeSpec", "SHAPES",
           "get_config", "list_archs", "register"]
