"""One module a traffic driver kind (``open_loop``, ``offline``), found by
the ``driver`` key of a traffic file."""
