"""The libav shim (``vepav.cpp``), built at first use and bound in ``ingest/av.py``."""
