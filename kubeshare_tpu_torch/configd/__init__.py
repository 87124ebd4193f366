from .configd import ConfigDaemon, write_scheduler_ip

__all__ = ["ConfigDaemon", "write_scheduler_ip"]
