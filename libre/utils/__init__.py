from libre.utils.image import encode_jpeg, encode_png, write_image

__all__ = ["encode_jpeg", "encode_png", "write_image"]
