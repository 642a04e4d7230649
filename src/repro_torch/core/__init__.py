"""The port's own copies of the SkyMemory core pieces the paged engine needs."""
