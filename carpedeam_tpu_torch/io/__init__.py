from .seqdb import SeqDB  # noqa: F401
