"""Native (C++) host components of the port: the wire codec (codec.cpp,
codec_native.py) and the GIL-free UDP reassembly loop (ingest.cpp,
ingest_native.py), built with g++ at first use by build.py."""
