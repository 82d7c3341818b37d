"""NVC, the built-in codec (port of ``elvis_tpu.codec.nvc``): ``transform``
is the device half, ``codec`` the container and rate control, ``entropy``
the binding of the native range coder."""
