"""ssd_scan: the Mamba2 SSD chunked scan."""
