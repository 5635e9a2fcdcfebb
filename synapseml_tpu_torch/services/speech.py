"""Speech service stages (reference: cognitive/.../speech/
SpeechToTextSDK.scala:600, SpeechToText.scala, TextToSpeech.scala — the
SDK streaming variant is out of scope; these are the HTTP-request
equivalents).  The PyTorch port's copy of the JAX package's
``services/speech.py``; SSML is escaped through ``xml.sax.saxutils``."""

from __future__ import annotations

from typing import Any, Dict

from xml.sax.saxutils import escape, quoteattr

from ..core.params import StringParam
from ..io.http import HTTPRequestData
from .base import RemoteServiceTransformer, with_query


class SpeechToText(RemoteServiceTransformer):
    """Audio → transcript (reference: speech/SpeechToText.scala — posts
    audio bytes with format/language query params)."""

    audioDataCol = StringParam(doc="audio bytes column", default="audio")
    language = StringParam(doc="speech language", default="en-US")
    format = StringParam(doc="simple | detailed", default="simple")

    def prepare_request(self, row: Dict[str, Any]) -> HTTPRequestData:
        url = with_query(self.url,
                         {"language": self.language, "format": self.format})
        return HTTPRequestData(
            url=url, method="POST",
            headers={"Content-Type": "audio/wav"},
            entity=bytes(row[self.audioDataCol]))

    def parse_response(self, value: Any) -> Any:
        if isinstance(value, dict) and "DisplayText" in value:
            return value["DisplayText"]
        return value


class TextToSpeech(RemoteServiceTransformer):
    """Text → audio bytes (reference: speech/TextToSpeech.scala — posts
    SSML, response entity is the audio)."""

    textCol = StringParam(doc="text column", default="text")
    language = StringParam(doc="voice language", default="en-US")
    voiceName = StringParam(doc="voice name", default="en-US-JennyNeural")
    outputFormat = StringParam(doc="audio output format",
                               default="riff-16khz-16bit-mono-pcm")
    binary_output = True

    def prepare_request(self, row: Dict[str, Any]) -> HTTPRequestData:
        ssml = (f"<speak version='1.0' xml:lang={quoteattr(self.language)}>"
                f"<voice name={quoteattr(self.voiceName)}>"
                f"{escape(str(row[self.textCol]))}</voice></speak>")
        return HTTPRequestData(
            url=self.url, method="POST",
            headers={"Content-Type": "application/ssml+xml",
                     "X-Microsoft-OutputFormat": self.outputFormat},
            entity=ssml.encode())


class ConversationTranscription(SpeechToText):
    """Multi-speaker transcription (reference: speech/
    ConversationTranscription.scala — same request shape, diarized
    response)."""
