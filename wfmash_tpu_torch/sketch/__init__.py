from .murmur import murmur3_x64_128_low64, murmur3_low64_scalar

__all__ = ["murmur3_x64_128_low64", "murmur3_low64_scalar"]
