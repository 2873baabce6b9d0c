"""The port's /t2v WebAPI: shared handlers, a stdlib server and a FastAPI app."""

from t2v_torch.api.app import create_app

__all__ = ["create_app"]
