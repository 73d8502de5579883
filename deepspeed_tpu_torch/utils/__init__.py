"""Host-side utilities of the port: durable IO and the CRC-framed log
(``wal.py``), tolerant environment parsing (``env.py``)."""
