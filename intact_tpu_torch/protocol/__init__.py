"""Wire protocol: websocket + msgpack-numpy, byte-compatible with the reference clients."""
