"""The serving edge's error classes, free of any transport.

The handlers (serving/flight_handlers.py) and the middleware raise these;
the pyarrow binding (serving/flight_server.py) raises the Flight error of
the same meaning with the same message, as longbow_tpu's server does:
FlightUnavailableError for UnavailableError and FlightServerError for
every other class. The message of each class carries the prefix a client
reads ("bad request: ", "not found: ", "resource exhausted: ").
"""
from __future__ import annotations


class ServingError(Exception):
    """A request the edge refuses; str(e) is the message sent back."""

    prefix = ""

    def __init__(self, detail):
        super().__init__(f"{self.prefix}{detail}")


class ServerError(ServingError):
    """A refusal without a category (FlightServerError)."""


class BadRequestError(ServerError):
    prefix = "bad request: "


class NotFoundError(ServerError):
    prefix = "not found: "


class ResourceExhaustedError(ServerError):
    prefix = "resource exhausted: "


class UnavailableError(ServingError):
    """Admission refused or the answer is not available now
    (FlightUnavailableError)."""
