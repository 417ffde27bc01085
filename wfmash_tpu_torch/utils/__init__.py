from .units import handy_parameter, is_a_number

__all__ = ["handy_parameter", "is_a_number"]
