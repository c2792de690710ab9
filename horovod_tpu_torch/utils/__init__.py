"""Utilities of the port: the Chrome-trace timeline."""
