"""One registry tying service errors to gRPC status codes.

The server aborts with ``<ClassName>: <message>`` details and the
status from this table; the client reverses the mapping by class name.
A single registry (instead of the previous two hand-maintained tables)
makes drift impossible — adding an error class here wires both sides.

A copy of the reference package's ``rpc/errors.py`` over the port's
error classes: the class names, and so the wire details, are the same.
"""

from __future__ import annotations

import grpc

from ..frontend.domain_handler import DomainAlreadyExistsError
from ..frontend.version_checker import (
    ClientVersionNotSupportedError,
)
from ..runtime import api as A
from ..runtime.controller import ShardOwnershipLostError
from ..runtime.persistence.errors import EntityNotExistsError

# class name → (grpc status, exception type). EntityNotExistsError (the
# persistence-layer sibling) maps to the SERVICE error on the client so
# callers handle one class.
REGISTRY = {
    "BadRequestError": (
        grpc.StatusCode.INVALID_ARGUMENT, A.BadRequestError),
    "EntityNotExistsServiceError": (
        grpc.StatusCode.NOT_FOUND, A.EntityNotExistsServiceError),
    "EntityNotExistsError": (
        grpc.StatusCode.NOT_FOUND, A.EntityNotExistsServiceError),
    "WorkflowExecutionAlreadyStartedServiceError": (
        grpc.StatusCode.ALREADY_EXISTS,
        A.WorkflowExecutionAlreadyStartedServiceError),
    "DomainAlreadyExistsError": (
        grpc.StatusCode.ALREADY_EXISTS, DomainAlreadyExistsError),
    "DomainNotActiveError": (
        grpc.StatusCode.FAILED_PRECONDITION, A.DomainNotActiveError),
    "CancellationAlreadyRequestedError": (
        grpc.StatusCode.ALREADY_EXISTS,
        A.CancellationAlreadyRequestedError),
    "QueryFailedError": (
        grpc.StatusCode.FAILED_PRECONDITION, A.QueryFailedError),
    "ServiceBusyError": (
        grpc.StatusCode.RESOURCE_EXHAUSTED, A.ServiceBusyError),
    "ClientVersionNotSupportedError": (
        grpc.StatusCode.FAILED_PRECONDITION,
        ClientVersionNotSupportedError),
    "InternalServiceError": (
        grpc.StatusCode.INTERNAL, A.InternalServiceError),
    # shard moved: retryable routing error (retryableClient.go)
    "ShardOwnershipLostError": (
        grpc.StatusCode.UNAVAILABLE, ShardOwnershipLostError),
}

ERROR_CODES = {name: code for name, (code, _) in REGISTRY.items()}
ERROR_TYPES = {name: typ for name, (_, typ) in REGISTRY.items()}
