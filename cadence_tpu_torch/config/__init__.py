"""Static configuration of the port (a trimmed copy of the reference
package's ``config/``: see ``static``)."""

from .static import AutopilotConfig, ConfigError, ReshardingConfig

__all__ = ["AutopilotConfig", "ConfigError", "ReshardingConfig"]
