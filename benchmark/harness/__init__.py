"""The benchmark's machinery: specs, the generator, the stream, the
trace reader and the reference that decides `correct`."""
