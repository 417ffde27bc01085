from .build import MinmerIndex, build_index

__all__ = ["MinmerIndex", "build_index"]
