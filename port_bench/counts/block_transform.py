"""Bytes the hand kernel's frame transform must move: the uint8 frames read
and written once, the int32 level map read once, and the float32 table of
``levels`` 8x8 operators once."""


def frame_transform_bytes(frames: int, height: int, width: int, channels: int = 3,
                          block: int = 8, levels: int = 4) -> int:
    pixels = frames * height * width * channels
    return 2 * pixels + 4 * frames * (height // block) * (width // block) + 4 * levels * block**2
