"""Edge→core transport layer: codecs, composition, payload accounting
(the PyTorch counterpart of ``repro/transport``)."""

from repro_torch.transport.codecs import (CODECS, Codec, ComposedCodec,
                                          codec_names, parse_codec,
                                          register_codec)
from repro_torch.transport.method import TransportMethod

__all__ = ["CODECS", "Codec", "ComposedCodec", "codec_names",
           "parse_codec", "register_codec", "TransportMethod"]
