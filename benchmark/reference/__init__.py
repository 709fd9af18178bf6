"""The plain reference: ``crowd.py`` (one step of the crowd in plain
PyTorch), ``routes.py`` (a judge of planned routes) and ``compare.py``
(the comparison that decides ``correct``).  It imports nothing of the
program and nothing of JAX."""
