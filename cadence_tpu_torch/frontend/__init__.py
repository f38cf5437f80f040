"""Frontend service: the stateless public API gateway.

Reference: service/frontend/ — WorkflowHandler (workflowHandler.go:
247-2850, the full public API), AdminHandler, DC-redirection policy,
version checker, per-domain rate limiting, and the domain handler
(common/domain/handler.go) it fronts.

A copy of the reference package's ``frontend/__init__.py``.
"""

from .domain_handler import (
    ArchivalStatus,
    DomainAlreadyExistsError,
    DomainHandler,
)
from .handler import WorkflowHandler
from .admin_handler import AdminHandler
from .dc_redirection import DCRedirectionHandler, SelectedAPIsForwardingPolicy
from .version_checker import ClientVersionChecker, ClientVersionNotSupportedError

__all__ = [
    "ArchivalStatus",
    "DomainAlreadyExistsError",
    "DomainHandler",
    "WorkflowHandler",
    "AdminHandler",
    "DCRedirectionHandler",
    "SelectedAPIsForwardingPolicy",
    "ClientVersionChecker",
    "ClientVersionNotSupportedError",
]
