from .server import AgentAPIServer, make_server

__all__ = ["AgentAPIServer", "make_server"]
