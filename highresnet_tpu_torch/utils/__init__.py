"""Host utilities of the port (``imageio``: 16-bit PNG IO and dtype ladders)."""
