"""Remote-service pipeline stages (reference: cognitive/); the PyTorch
port of the JAX package's ``services``.

The ServiceParam pattern, a retrying/concurrent service base, and the
service families — text analytics, OpenAI-style
completion/embedding/prompt, vision, face, form recognizer, translator,
speech, anomaly detection (incl. multivariate), search sink, bing image
search, and geospatial.  They run on the host: each row becomes one
HTTP request through :mod:`synapseml_tpu_torch.io.http`, so none of them
takes a ``device``.  Endpoints are configurable URLs; the tests and
``chip_smoke.py`` drive them against local servers on 127.0.0.1.
"""

from .base import (HasServiceParams, RemoteServiceTransformer, ServiceParam)
from .openai import (OpenAICompletion, OpenAIEmbedding, OpenAIPrompt)
from .text import (AnalyzeHealthText, EntityDetector, KeyPhraseExtractor,
                   LanguageDetector, NER, PII, TextAnalyze, TextSentiment)
from .vision import (AnalyzeImage, DescribeImage, GenerateThumbnails, OCR,
                     ReadImage, RecognizeDomainSpecificContent, TagImage)
from .face import (DetectFace, FindSimilarFace, GroupFaces, IdentifyFaces,
                   VerifyFaces)
from .form import (AnalyzeBusinessCards, AnalyzeCustomModel,
                   AnalyzeIDDocuments, AnalyzeInvoices, AnalyzeLayout,
                   AnalyzeReceipts, FormOntologyLearner, FormOntologyModel)
from .translate import (BreakSentence, Detect, DictionaryExamples,
                        DictionaryLookup, Translate, Transliterate)
from .speech import ConversationTranscription, SpeechToText, TextToSpeech
from .anomaly import (DetectAnomalies, DetectLastAnomaly,
                      DetectMultivariateAnomaly, FitMultivariateAnomaly,
                      SimpleDetectAnomalies)
from .search import AddDocuments, AzureSearchWriter
from .bing import BingImageSearch
from .geospatial import (AddressGeocoder, CheckPointInPolygon,
                         ReverseAddressGeocoder)

__all__ = [
    "HasServiceParams", "RemoteServiceTransformer", "ServiceParam",
    "OpenAICompletion", "OpenAIEmbedding", "OpenAIPrompt",
    "KeyPhraseExtractor", "TextSentiment", "LanguageDetector",
    "EntityDetector", "NER", "PII", "AnalyzeHealthText", "TextAnalyze",
    "AnalyzeImage", "DescribeImage", "OCR", "ReadImage", "TagImage",
    "GenerateThumbnails", "RecognizeDomainSpecificContent",
    "DetectFace", "FindSimilarFace", "GroupFaces", "IdentifyFaces",
    "VerifyFaces",
    "AnalyzeLayout", "AnalyzeReceipts", "AnalyzeBusinessCards",
    "AnalyzeInvoices", "AnalyzeIDDocuments", "AnalyzeCustomModel",
    "FormOntologyLearner", "FormOntologyModel",
    "Translate", "Transliterate", "Detect", "BreakSentence",
    "DictionaryLookup", "DictionaryExamples",
    "SpeechToText", "TextToSpeech", "ConversationTranscription",
    "DetectLastAnomaly", "DetectAnomalies", "SimpleDetectAnomalies",
    "FitMultivariateAnomaly", "DetectMultivariateAnomaly",
    "AddDocuments", "AzureSearchWriter", "BingImageSearch",
    "AddressGeocoder", "ReverseAddressGeocoder", "CheckPointInPolygon",
]
