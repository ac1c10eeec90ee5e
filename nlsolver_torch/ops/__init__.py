from .de_fused import de_generation_fused, de_generation_reference

__all__ = ["de_generation_fused", "de_generation_reference"]
